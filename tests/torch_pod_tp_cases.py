"""Shared cases of the tensor-parallel pod tests (``test_torch_pod_tp*.py``):
the port's pod step on a state placed over a (data, model) gloo mesh of W
spawned processes, against the same step unsharded in the test's process.

Each rank builds the same whole params from one seed, places the state by
``param_specs`` (as ``launch/train.py`` does), runs two SGD steps on its
rows of each batch (``batch_shardings``), and returns the whole params
(gathered), the federation state and the metrics.  The ``LAYOUTS`` cases
run ``robust=None`` with the state in another layout, ZeRO-1's among them
(its compute copy in bf16); the unsharded ZeRO-1 step runs on a 1 x 1
mesh.  Spawned processes are joined under a timeout each, so a hang fails
the test instead of eating the suite's time.
"""
import queue as queue_mod
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch import tree
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import pod
from repro_torch.launch import inputs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.sharding import dtensor, specs

TIMEOUT = 240                   # seconds for the spawned processes
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=128, head_dim=16)
# one config a block kind, at SMALL widths
KINDS = {
    "attn": ARCHS["tiny-lm"].replace(**SMALL),
    "moe": ARCHS["granite-moe-1b-a400m"].reduced().replace(**SMALL),
    "hybrid": ARCHS["hymba-1.5b"].reduced().replace(**SMALL),
    "xlstm": ARCHS["xlstm-350m"].reduced().replace(**SMALL),
    "xattn": ARCHS["llama-3.2-vision-90b"].reduced().replace(
        cross_attn_every=2, **SMALL),
    # head counts that do not split over a "model" axis of 2: 3 q heads in
    # one kv group (padded to 2 groups), and 3 mLSTM heads (padded to 4)
    "attn_uneven": ARCHS["tiny-lm"].replace(
        **dict(SMALL, n_heads=3, n_kv_heads=1)),
    "xlstm_uneven": ARCHS["xlstm-350m"].reduced().replace(
        **dict(SMALL, d_model=48, n_heads=3, n_kv_heads=3)),
    # granite at small widths with a capacity that drops routed pairs
    "moe_drop": ARCHS["granite-moe-1b-a400m"].reduced().replace(
        capacity_factor=0.5, **SMALL),
}
C, GB, S = 4, 8, 16             # clients, global batch, sequence
ROBUST = {"none": (None, {}),
          "fedavg": ("per_client", {}),
          "trimmed_mean": ("per_client", dict(aggregator="trimmed_mean")),
          "krum": ("per_client", dict(aggregator="krum")),
          "int8": ("per_client", dict(compress="int8"))}
# robust=None in another layout: case -> (the state's layout, ZeRO-1's
# compute layout or None), by ``sharding/specs.py`` function
LAYOUTS = {"moe_ff": ("param_specs_moe_ff", None),
           "zero1": ("param_specs", "param_specs_tp"),
           "zero1_moe": ("param_specs_moe_ff", "param_specs_zero1_moe")}
ATOL, THETA_ATOL = 1e-5, 5e-4
BF16_REL = 1e-2     # ZeRO-1 computes in bf16, rounded in other orders


def batches(cfg):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (GB, S + 1)))
        b = {"targets": toks[:, 1:].clone()}
        if cfg.embed_inputs:
            b["tokens"] = toks[:, :-1].clone()
        else:
            b["embeds"] = torch.from_numpy(rng.standard_normal(
                (GB, S, cfg.d_model)).astype(np.float32))
        if cfg.arch_type == "vlm":
            b["image_embeds"] = torch.from_numpy(rng.standard_normal(
                (GB, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
        out.append(b)
    return out


def run(kind, case, mesh=None):
    """Two pod steps of ``kind`` under ``case``; with ``mesh`` on a state
    placed by ``param_specs`` (a ``LAYOUTS`` case: by its layout) and this
    rank's rows of each batch.  The unsharded ZeRO-1 step runs on a 1 x 1
    mesh of its own."""
    master, compute = LAYOUTS.get(case, ("param_specs", None))
    if mesh is None and compute is not None:
        with mesh_mod.host_mesh(device="cpu") as one:
            return _run(kind, case, one, master, compute)
    return _run(kind, case, mesh, master, compute)


def _run(kind, case, mesh, master, compute):
    cfg = KINDS[kind]
    robust, fed_kw = ROBUST.get(case, (None, {}))
    fed = FedConfig(n_clients=C, **fed_kw)
    tc = TrainConfig(global_batch=GB, seq_len=S, lr=1e-2, warmup_steps=1,
                     total_steps=4, optimizer="sgd")
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg)
    init = tree.map(lambda v: v.float().numpy().copy(), params)
    opt_init, _ = optimizers.make_optimizer(tc)
    agg = mesh if robust else None
    layout = lambda t, f: specs.named(mesh, getattr(specs, f)(t, mesh=mesh))
    kw = {}
    if compute is not None:
        kw["zero1_shardings"] = (layout(params, compute),
                                 layout(params, master))
    shardings = None if mesh is None else (lambda st: layout(st, master))
    state = pod.init_pod_state(params, opt_init, C, fed,
                               torch.Generator().manual_seed(1), mesh=agg,
                               shardings=shardings)
    step = pod.make_train_step(cfg, fed, tc, robust=robust, agg_mesh=agg,
                               **kw)
    metrics = []
    for b in batches(cfg):
        if mesh is not None:
            bsh = inputs.batch_shardings(b, mesh)
            b = {k: bsh[k].local(v) for k, v in b.items()}
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": tree.map(lambda v: v.float().numpy(),
                               dtensor.whole(state.params)), "init": init,
            "team": state.fed.team.numpy(), "h": bool(state.fed.h),
            "trust": state.fed.trust.numpy(), "metrics": metrics}


AGG_C = 8


def agg_tree(rows=slice(None)):
    """(AGG_C, ...) client updates: a leaf that splits over 2 ranks (with
    its int8 quant blocks), a ragged one and a tiny one that stay whole."""
    rng = np.random.default_rng(0)
    t = {"w": rng.standard_normal((AGG_C, 64, 8), np.float32),
         "r": rng.standard_normal((AGG_C, 301), np.float32),
         "b": rng.standard_normal((AGG_C, 5), np.float32)}
    return {k: torch.from_numpy(v[rows].copy()) for k, v in t.items()}


def agg_wm():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.uniform(0.1, 1.1, AGG_C).astype(np.float32))
    m = torch.ones(AGG_C)
    m[2] = 0.0
    return w, m


def agg_record(t):
    from repro_torch.comm import codecs
    like = tree.map(lambda l: l[0], t)
    layout = codecs.WireLayout([l.numel() for l in tree.leaves(like)], 128)
    enc = codecs.Codec("int8", qblk=128).encode_flat(
        tree.flatten_rows(t).float(), layout)
    return enc, layout, like


def run_axes(axes, mesh):
    """``aggregate_sharded`` and ``fused_dequant_aggregate_sharded`` over
    ``axes`` of the mesh, each rank given the rows of its clients within
    its sub-group (the same rows at every coordinate of the other axes),
    for every aggregator."""
    from repro_torch.comm.kernels import comm_codecs as dq
    from repro_torch.core import aggregation
    sub = mesh.over(axes)
    n = AGG_C // sub.size
    local = agg_tree(slice(sub.rank * n, (sub.rank + 1) * n))
    enc, layout, like = agg_record(local)
    w, m = agg_wm()
    out = {}
    for agg in ("fedavg", "median", "trimmed_mean", "krum"):
        cfg = FedConfig(n_clients=AGG_C, aggregator=agg)
        out["dense", agg] = tree.map(
            lambda v: v.numpy(),
            aggregation.aggregate_sharded(local, w, m, cfg, mesh, axes))
        out["int8", agg] = tree.map(
            lambda v: v.numpy(), dq.fused_dequant_aggregate_sharded(
                enc, layout, w, m, cfg, mesh, like=like, axes=axes))
    return out


TP_SPLIT, TP_WHOLE = 66, 37


def tp_updates():
    """(AGG_C, 66) columns split over "model" and (AGG_C, 37) whole ones;
    the seed makes Krum's choice change if the whole columns counted
    twice."""
    rng = np.random.default_rng(2)
    return (rng.standard_normal((AGG_C, TP_SPLIT), np.float32),
            rng.standard_normal((AGG_C, TP_WHOLE), np.float32) * 1.5)


def run_tp(mesh):
    """``aggregation.aggregate_tp`` on each rank's rows (its data index's
    clients) of its block of the split columns and of the whole ones,
    packed into the send layout (``tp_columns(n, mesh).pack``), for every
    aggregator."""
    from repro_torch.core import aggregation
    D, M = mesh.shape
    d, m = mesh.coords()
    split, whole = tp_updates()
    rows = slice(d * AGG_C // D, (d + 1) * AGG_C // D)
    cols = slice(m * TP_SPLIT // M, (m + 1) * TP_SPLIT // M)
    send = [aggregation.tp_columns(x.shape[1], mesh).pack(torch.from_numpy(
        x.copy())) for x in (split[rows, cols], whole[rows])]
    w, mask = agg_wm()
    out = {}
    for agg in ("fedavg", "median", "trimmed_mean", "krum"):
        cfg = FedConfig(n_clients=AGG_C, aggregator=agg)
        out[agg] = tuple(o.numpy() for o in aggregation.aggregate_tp(
            *send, w, mask, cfg, mesh))
    return out


SERVE_B, SERVE_S, SERVE_DECODE, SERVE_LEN = 4, 8, 3, 16
# the serving cases' configs: fp32, the hybrid's window shorter than the
# prompt + decode so its ring cache wraps
SERVE_KINDS = {"attn": KINDS["attn"], "moe": KINDS["moe"],
               "hybrid": KINDS["hybrid"].replace(sliding_window=8),
               "xlstm": KINDS["xlstm"]}
SERVE_ATOL = 1e-5


def run_serve(kind, variant, mesh=None):
    """``Model.prefill`` of a (4, 8) prompt, then three ``Model.decode``
    steps, on plain tensors or (``mesh``) on params placed by
    ``param_specs`` (``param_specs_tp`` under ``tp_serve``), a cache placed
    by ``cache_specs`` and the batch's rows split over "data"; the
    hybrid's cache is a ring.  Returns the logits of each call, whole."""
    from repro_torch.models.model import build
    cfg = SERVE_KINDS[kind]
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SERVE_B, SERVE_S + SERVE_DECODE)))
    cache = model.init_cache(SERVE_B, SERVE_LEN, ring=kind == "hybrid",
                             dtype=torch.float32)
    batches = [{"tokens": toks[:, :SERVE_S]}] + [
        {"tokens": toks[:, SERVE_S + t:SERVE_S + t + 1]}
        for t in range(SERVE_DECODE)]
    if mesh is not None:
        fn = specs.param_specs_tp if variant == "tp_serve" \
            else specs.param_specs
        params = dtensor.place(params, specs.named(mesh, fn(params,
                                                            mesh=mesh)))
        cache = dtensor.place(cache, specs.named(mesh, specs.cache_specs(
            cache, mesh)))
        batches = [dtensor.place(b, specs.named(mesh, specs.batch_specs(
            b, mesh))) for b in batches]
    with torch.no_grad():
        out, cache = model.prefill(params, batches[0], cache)
        logits = [out]
        for t, b in enumerate(batches[1:]):
            out, cache = model.decode(params, b, cache, SERVE_S + t)
            logits.append(out)
    return [dtensor.plain(l).numpy() for l in logits]


def check_serve(got, ref):
    """Each call's logits within SERVE_ATOL of the plain call's largest."""
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=SERVE_ATOL * np.abs(r).max())


# a stacked KV leaf (U, B, L, Hkv, dh) and the runs written into its
# sequence dim as (start, length): across a piece boundary, wrapping past
# the end, the whole length, one slot
WRITE_SHAPE = (1, 4, 16, 2, 3)
WRITE_RUNS = ((5, 7), (14, 5), (0, 16), (3, 1))


def write_inputs():
    """The KV leaf before the writes, and each run's source."""
    rng = np.random.default_rng(5)
    draw = lambda shape: rng.standard_normal(shape).astype(np.float32)
    init = draw(WRITE_SHAPE)
    return init, [draw(WRITE_SHAPE[:2] + (n,) + WRITE_SHAPE[3:])
                  for _, n in WRITE_RUNS]


def run_write(mesh=None):
    """``dtensor.write_run_`` of each of WRITE_RUNS, in turn, into the KV
    leaf, plain or placed by ``cache_specs`` (``mesh``), each under a
    ``CostCounter`` -> (the leaf whole after each run, the collective
    bytes the writes moved)."""
    from repro_torch.launch import roofline
    init, srcs = write_inputs()
    cache = {"k": torch.from_numpy(init)}
    if mesh is not None:
        cache = dtensor.place(cache, specs.named(mesh, specs.cache_specs(
            cache, mesh)))
    outs, moved = [], 0
    for (start, _), src in zip(WRITE_RUNS, srcs):
        counter = roofline.CostCounter()
        with counter:
            dtensor.write_run_(cache["k"], 2, torch.tensor(start),
                               torch.from_numpy(src))
        moved += sum(counter.costs()[1].values())
        outs.append(dtensor.plain(cache["k"]).numpy().copy())
    return outs, moved


def run_remat(kind, mesh=None):
    """One SGD pod step (``robust=None``) of ``kind`` with ``remat`` on and
    off, from the same init and batch, on a state placed by
    ``param_specs`` (``mesh``) or plain -> {remat: whole params}."""
    out = {}
    for remat in (True, False):
        cfg = KINDS[kind].replace(remat=remat)
        fed = FedConfig(n_clients=C)
        tc = TrainConfig(global_batch=GB, seq_len=S, lr=1e-2, warmup_steps=1,
                         total_steps=4, optimizer="sgd")
        params = transformer.init_transformer(
            torch.Generator().manual_seed(0), cfg)
        opt_init, _ = optimizers.make_optimizer(tc)
        shardings = None if mesh is None else (
            lambda st: specs.named(mesh, specs.param_specs(st, mesh=mesh)))
        state = pod.init_pod_state(params, opt_init, C, fed,
                                   torch.Generator().manual_seed(1),
                                   shardings=shardings)
        b = batches(cfg)[0]
        if mesh is not None:
            bsh = inputs.batch_shardings(b, mesh)
            b = {k: bsh[k].local(v) for k, v in b.items()}
        state, _ = pod.make_train_step(cfg, fed, tc)(state, b)
        out[remat] = tree.map(lambda v: v.float().numpy(),
                              dtensor.whole(state.params))
    return out


def run_dispatch(mesh):
    """``moe.placed_dispatch`` of routing keys placed as a batch's rows
    (split over "data") on ``mesh``, for the dropping config: (order, tok,
    keep, dest) as numpy."""
    from repro_torch.models import moe
    cfg = KINDS["moe_drop"]
    top_e = dispatch_keys()
    placed = dtensor.place({"e": top_e}, specs.named(mesh, specs.batch_specs(
        {"e": top_e}, mesh)))["e"]
    order, tok, _, _, _, keep, dest = moe.placed_dispatch(
        placed, top_e.shape[0], cfg)
    return [t.numpy() for t in (order, tok, keep, dest)]


def dispatch_keys():
    """(N, K) routing keys of the dropping config, skewed so that experts
    overflow their capacity."""
    cfg = KINDS["moe_drop"]
    rng = np.random.default_rng(11)
    p = np.array([0.55, 0.25, 0.15, 0.05])[:cfg.n_experts]
    keys = np.stack([rng.choice(cfg.n_experts, cfg.top_k, replace=False,
                                p=p / p.sum()) for _ in range(GB * S)])
    return torch.from_numpy(keys)


DECODE_STEPS = 4


def run_greedy(kind, mesh=None):
    """``Model.prefill`` of a (4, 8) prompt and DECODE_STEPS greedy
    ``Model.decode`` steps, each fed the argmax of the last logits, on
    plain tensors or (``mesh``) on params placed by ``param_specs`` and a
    cache placed by ``cache_specs`` (split on its sequence over "model")
    -> (the logits of each call, whole; the tokens chosen)."""
    from repro_torch.models.model import build
    cfg = SERVE_KINDS.get(kind, KINDS.get(kind))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (SERVE_B, SERVE_S)))
    cache = model.init_cache(SERVE_B, SERVE_LEN, dtype=torch.float32)
    place = lambda b: b
    if mesh is not None:
        params = dtensor.place(params, specs.named(
            mesh, specs.param_specs(params, mesh=mesh)))
        cache = dtensor.place(cache, specs.named(mesh, specs.cache_specs(
            cache, mesh)))
        place = lambda b: dtensor.place(b, specs.named(
            mesh, specs.batch_specs(b, mesh)))
    logits, tokens = [], []
    with torch.no_grad():
        out, cache = model.prefill(params, place({"tokens": prompt}), cache)
        for t in range(DECODE_STEPS):
            out = dtensor.plain(out)
            logits.append(out.numpy())
            tok = out[:, -1].argmax(-1)
            tokens.append(tok.numpy())
            out, cache = model.decode(params, place({"tokens": tok[:, None]}),
                                      cache, SERVE_S + t)
        logits.append(dtensor.plain(out).numpy())
    return logits, np.stack(tokens)


LSE_SHAPE = (2, 3, 2, 2, 16)          # q: (B, S, Hkv, G, dh)
LSE_T = 16


def lse_inputs():
    """q, k, v and a mask that leaves some keys of every query masked
    (whole pieces of T among them)."""
    rng = np.random.default_rng(9)
    B, S, H, G, dh = LSE_SHAPE
    q = rng.standard_normal(LSE_SHAPE).astype(np.float32)
    k, v = (rng.standard_normal((B, LSE_T, H, dh)).astype(np.float32)
            for _ in range(2))
    kpos = np.arange(LSE_T)[None, :]
    mask = kpos <= (np.arange(S)[:, None] + 5)
    return [torch.from_numpy(x) for x in (q, k, v, mask[None, None, None])]


def run_lse(mesh):
    """``attention._sdpa`` with k and v placed as a cache is (T split over
    "model") and q whole: the log-sum-exp combine across the ranks."""
    from repro_torch.models import attention
    q, k, v, mask = lse_inputs()
    kv = dtensor.place({"k": k[None], "v": v[None]}, specs.named(
        mesh, specs.cache_specs({"k": k[None], "v": v[None]}, mesh)))
    B, S, H, G, dh = LSE_SHAPE
    hd = attention._Heads(H * G, H, G, dh, H * G, None, None)
    q = q.reshape(B, S, H * G, dh)
    qd = dtensor.place(q, specs.named(mesh, specs.P(*([None] * q.dim()))))
    out = attention._sdpa(qd, kv["k"][0], kv["v"][0], mask, hd)
    return dtensor.plain(out).numpy()


def _worker(rank, shape, cases, store_dir, out_q):
    try:
        torch.set_num_threads(1)
        W = shape[0] * shape[1]
        mesh_mod.start_group("cpu", world_size=W, rank=rank,
                             store_dir=store_dir)
        mesh = mesh_mod.make_host_mesh(*shape)
        out_q.put((rank, {(k, c): (run_axes(c, mesh) if k == "axes"
                                   else run_tp(mesh) if k == "tp"
                                   else run_serve(*c, mesh) if k == "serve"
                                   else run_remat(c, mesh) if k == "remat"
                                   else run_write(mesh) if k == "write"
                                   else run_dispatch(mesh) if k == "dispatch"
                                   else run_greedy(c, mesh) if k == "greedy"
                                   else run_lse(mesh) if k == "lse"
                                   else run(k, c, mesh))
                          for k, c in cases}))
    except Exception:                   # reported by the test, not lost
        out_q.put((rank, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn(shape, cases, store_dir):
    """Runs ``cases`` ((kind, case) pairs) on a ``shape`` mesh of spawned
    gloo processes -> {rank: {(kind, case): result}}."""
    W = shape[0] * shape[1]
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, shape, cases, store_dir, out_q))
             for r in range(W)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:                 # drain before joining
            rank, out = out_q.get(timeout=TIMEOUT)
            results[rank] = out
    except queue_mod.Empty:
        pytest.fail(f"the {shape} mesh did not finish in {TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    for rank, out in results.items():
        if isinstance(out, str):
            pytest.fail(f"rank {rank} failed:\n{out}")
    return results


def check(got, ref, case=None):
    """Teams and h equal, params and trust within 1e-5, theta within 5e-4
    (``tests/test_torch_pod.py`` says why), the other metrics within
    1e-5.  A ZeRO-1 case (bf16 compute) is held by ``check_bf16``."""
    if LAYOUTS.get(case, (None, None))[1] is not None:
        return check_bf16(got, ref)
    np.testing.assert_array_equal(got["team"], ref["team"])
    assert got["h"] == ref["h"]
    np.testing.assert_allclose(got["trust"], ref["trust"], atol=ATOL)
    for a, b in zip(tree.leaves(got["params"]), tree.leaves(ref["params"])):
        np.testing.assert_allclose(a, b, atol=ATOL)
    for gm, rm in zip(got["metrics"], ref["metrics"]):
        for k in rm:
            np.testing.assert_allclose(
                gm[k], rm[k], rtol=1e-5, err_msg=k,
                atol=THETA_ATOL if k == "theta_team" else ATOL)


def check_bf16(got, ref):
    """ZeRO-1 against the unsharded ZeRO-1 step: teams and h equal; loss
    and grad_norm of each step within 1e-2 relative; each param's change
    over the two steps within 1e-2 of the largest change (a step that lost
    a part of its grads moves its params by another amount)."""
    np.testing.assert_array_equal(got["team"], ref["team"])
    assert got["h"] == ref["h"]
    for gm, rm in zip(got["metrics"], ref["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(gm[k], rm[k], rtol=BF16_REL,
                                       err_msg=k)
    moved = [b - i for b, i in zip(tree.leaves(ref["params"]),
                                   tree.leaves(ref["init"]))]
    largest = max(float(np.abs(m).max()) for m in moved)
    for a, b in zip(tree.leaves(got["params"]), tree.leaves(ref["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=BF16_REL * largest)


def module_tests(shape, kinds, cases):
    """A test module's fixtures and test: the ``cases`` of each of
    ``kinds`` on a ``shape`` mesh of spawned processes, each rank held to
    the unsharded step (``check``).  Returns (one_thread, ranks, test) for
    the module's globals."""

    @pytest.fixture(autouse=True, scope="module")
    def one_thread():
        """Small models: one intra-op thread keeps the suite's parallel
        workers from oversubscribing the cores."""
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    @pytest.fixture(scope="module")
    def ranks(tmp_path_factory):
        return spawn(shape, [(k, c) for k in kinds for c in cases],
                     str(tmp_path_factory.mktemp("pod_tp")))

    @pytest.mark.parametrize("case", cases)
    @pytest.mark.parametrize("kind", kinds)
    def test(ranks, kind, case):
        ref = run(kind, case)
        for r in ranks:
            check(ranks[r][kind, case], ref, case)

    return one_thread, ranks, test
