"""The mesh-sharded robust aggregation and the data-parallel pod step of the
port on the CPU: a gloo process group of world size 2 in two spawned
processes (each joined under its own timeout, so that a hang fails the
test instead of eating the suite's time), against the unsharded port.

  * ``aggregation.aggregate_sharded`` and
    ``comm_codecs.fused_dequant_aggregate_sharded`` at W = 2, each rank
    given only its clients' rows, against ``aggregation.aggregate`` and
    ``fused_dequant_aggregate_tree`` on every row, for all four
    aggregators, on a tree with a split leaf, leaves that stay whole
    (ragged, tiny) and a bf16 leaf: within 1e-5 (the cross-rank sums of
    the partials and the Gram add in another order), bf16 within 2e-2 as
    in ``tests/test_sharded_agg.py``; both ranks return the same aggregate;
  * what crosses the ranks, the summed pass-1 partials and Krum's Gram,
    equal to those of the whole matrix (a leaf held whole by every rank
    counts once), within 1e-5 of the largest;
  * the shard flags and specs equal to JAX's ``client_flat_specs``;
  * two pod steps (``make_train_step(agg_mesh=)``, each rank on its rows of
    the batch) at W = 2 against W = 1: teams and h equal, params and trust
    within 1e-5, the team's theta within 5e-4 (``tests/test_torch_pod.py``
    says why);
  * the port's ``aggregate_sharded`` at W = 1 (a gloo group of one)
    against the JAX package's ``aggregate_sharded`` on a one-device mesh,
    and the fused-dequant pair likewise: within 1e-5.
"""
import queue as queue_mod
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.comm import codecs as jcodecs
from repro.comm.kernels import comm_codecs as jdq
from repro.configs.base import FedConfig as JFedConfig
from repro.core import aggregation as jaggregation
from repro.sharding import specs as jspecs
from repro_torch import interop, tree
from repro_torch.comm import codecs
from repro_torch.comm.kernels import comm_codecs as dq
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import aggregation, pod
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import transformer
from repro_torch.optim import optimizers
from repro_torch.sharding import specs

AGGS = ["fedavg", "median", "trimmed_mean", "krum"]
C, W, QBLK = 8, 2, 128
TIMEOUT = 240                   # seconds for the spawned processes
SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=128, head_dim=16)
CFG = ARCHS["tiny-lm"].replace(**SMALL)
PC, PB, PS = 4, 8, 32           # the pod step's clients, batch, sequence
POD_CASES = {"trimmed_mean": dict(aggregator="trimmed_mean"),
             "int8": dict(compress="int8")}
ATOL, THETA_ATOL = 1e-5, 5e-4


def _np_tree():
    """A split leaf (512 = 2 x 2 x 128), a ragged and a tiny leaf that stay
    whole, and a bf16 leaf that splits (256)."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((C, 64, 8), np.float32),
            "r": rng.standard_normal((C, 301), np.float32),
            "b": rng.standard_normal((C, 5), np.float32),
            "h": rng.standard_normal((C, 256), np.float32)}


def _tree(rows=slice(None)):
    t = {k: torch.from_numpy(v[rows].copy()) for k, v in _np_tree().items()}
    t["h"] = t["h"].bfloat16()
    return t


def _wm():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.uniform(0.1, 1.1, C).astype(np.float32))
    m = torch.ones(C)
    m[2] = 0.0
    return w, m


def _record(t):
    """The int8 record of a tree's rows, its layout and the params-like
    tree of its leaves."""
    like = tree.map(lambda l: l[0], t)
    layout = codecs.WireLayout([l.numel() for l in tree.leaves(like)], QBLK)
    enc = codecs.Codec("int8", qblk=QBLK).encode_flat(
        tree.flatten_rows(t).float(), layout)
    return enc, layout, like


def _np(t):
    return tree.map(lambda v: v.float().numpy(), t)


def _pod_batches():
    rng = np.random.default_rng(7)
    toks = rng.integers(0, CFG.vocab_size, (2, PB, PS + 1))
    return [{"tokens": torch.from_numpy(t[:, :-1].copy()),
             "targets": torch.from_numpy(t[:, 1:].copy())} for t in toks]


def _pod_run(fed_kw, mesh=None, rows=slice(None)):
    fed = FedConfig(n_clients=PC, **fed_kw)
    tc = TrainConfig(global_batch=PB, seq_len=PS, lr=1e-2, warmup_steps=1,
                     total_steps=4, optimizer="sgd")
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          CFG)
    opt_init, _ = optimizers.make_optimizer(tc)
    state = pod.init_pod_state(params, opt_init, PC, fed,
                               torch.Generator().manual_seed(1), mesh=mesh)
    step = pod.make_train_step(CFG, fed, tc, robust="per_client",
                               agg_mesh=mesh)
    metrics = []
    for b in _pod_batches():
        state, m = step(state, {k: v[rows] for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": _np(state.params), "team": state.fed.team.numpy(),
            "h": bool(state.fed.h), "trust": state.fed.trust.numpy(),
            "metrics": metrics}


def _spy_on_the_pipeline():
    """Records what crosses the ranks in the sharded pipeline: the summed
    pass-1 partials the gate reads and the Gram Krum reads (numpy, the
    last call's), in a dict this returns."""
    seen = {}
    gate, dists = rp._resolve_gate, rp.sq_dists_from_gram

    def spy_gate(dots, sqn, refsq, mask, thresh):
        seen["partials"] = torch.cat([dots, sqn, refsq], 1).numpy().copy()
        return gate(dots, sqn, refsq, mask, thresh)

    def spy_dists(gram, mask):
        seen["gram"] = gram.numpy().copy()
        return dists(gram, mask)

    rp._resolve_gate, rp.sq_dists_from_gram = spy_gate, spy_dists
    return seen


def _worker(rank, store_dir, out_q):
    """One rank of the W = 2 gloo group: every sharded computation on its
    rows; puts (rank, results) or (rank, traceback) on ``out_q``."""
    try:
        torch.set_num_threads(1)
        mesh_mod.start_group("cpu", world_size=W, rank=rank,
                             store_dir=store_dir)
        mesh = mesh_mod.make_host_mesh(W)
        rows = slice(rank * C // W, (rank + 1) * C // W)
        w, m = _wm()
        local = _tree(rows)
        enc, layout, like = _record(local)
        out = {}
        seen = _spy_on_the_pipeline()
        for agg in AGGS:
            cfg = FedConfig(n_clients=C, aggregator=agg)
            out["dense", agg] = _np(aggregation.aggregate_sharded(
                local, w, m, cfg, mesh))
            out["dense like", agg] = _np(aggregation.aggregate_sharded(
                tree.flatten_rows(local).float(), w, m, cfg, mesh,
                like=like))
            out["dense partials", agg] = dict(seen)
            out["int8", agg] = _np(dq.fused_dequant_aggregate_sharded(
                enc, layout, w, m, cfg, mesh, like=like))
            out["int8 partials", agg] = dict(seen)
        prow = slice(rank * PB // W, (rank + 1) * PB // W)
        for name, fed_kw in POD_CASES.items():
            out["pod", name] = _pod_run(fed_kw, mesh, prow)
        out_q.put((rank, out))
    except Exception:                   # reported by the test, not lost
        out_q.put((rank, traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The models here are tiny: one intra-op thread keeps the suite's
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    store_dir = str(tmp_path_factory.mktemp("pod_sharded"))
    procs = [ctx.Process(target=_worker, args=(r, store_dir, out_q))
             for r in range(W)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:                 # drain before joining
            rank, out = out_q.get(timeout=TIMEOUT)
            results[rank] = out
    except queue_mod.Empty:
        pytest.fail(f"the W = {W} group did not finish in {TIMEOUT} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    for rank, out in results.items():
        if isinstance(out, str):
            pytest.fail(f"rank {rank} failed:\n{out}")
    return results


def _close(got, ref, bf16_atol=2e-2):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], err_msg=k,
                                   atol=bf16_atol if k == "h" else ATOL)


@pytest.mark.parametrize("agg", AGGS)
def test_aggregate_sharded_like_buffer_w2_matches_unsharded(ranks, agg):
    """The pod step's call at W = 2: each rank's (C/W, N) fp32 buffer with
    ``like`` (its reshard by one all_to_all, then the body) against
    ``aggregate`` of the whole tree, the same on both ranks."""
    w, m = _wm()
    full = _tree()
    cfg = FedConfig(n_clients=C, aggregator=agg)
    ref = _np(aggregation.aggregate(full, w, m, cfg))
    _close(ranks[0]["dense like", agg], ref)
    for k in ref:
        np.testing.assert_array_equal(ranks[0]["dense like", agg][k],
                                      ranks[1]["dense like", agg][k])
        np.testing.assert_array_equal(ranks[0]["dense like", agg][k],
                                      ranks[0]["dense", agg][k])


@pytest.mark.parametrize("agg", AGGS)
def test_aggregate_sharded_w2_matches_unsharded(ranks, agg):
    w, m = _wm()
    full = _tree()
    cfg = FedConfig(n_clients=C, aggregator=agg)
    ref = _np(aggregation.aggregate(full, w, m, cfg))
    _close(ranks[0]["dense", agg], ref)
    for k in ref:                       # every rank holds the whole result
        np.testing.assert_array_equal(ranks[0]["dense", agg][k],
                                      ranks[1]["dense", agg][k])
    enc, layout, like = _record(full)
    ref = _np(dq.fused_dequant_aggregate_tree(enc, layout, w, m, cfg,
                                              like=like))
    _close(ranks[0]["int8", agg], ref)
    for k in ref:
        np.testing.assert_array_equal(ranks[0]["int8", agg][k],
                                      ranks[1]["int8", agg][k])


@pytest.mark.parametrize("agg", ["fedavg", "krum"])
def test_sharded_partials_are_the_unsharded_ones(ranks, agg):
    """The pass-1 partials (and Krum's Gram) summed over the ranks equal
    those of the whole matrix: a leaf held whole by every rank counts
    once."""
    w, m = _wm()
    full = tree.flatten_rows(_tree()).float()[None]
    enc, layout, _ = _record(_tree())
    refs = {"dense partials": (rp.cosine_gate_partials_plain(full, m[None]),
                               rp.pairwise_gram_plain(full)),
            "int8 partials": (dq.dequant_gate_partials_plain(
                enc.q[None], enc.s[None], layout, m[None]),
                dq.dequant_pairwise_gram_plain(enc.q[None], enc.s[None],
                                               layout, m[None]))}
    for kind, (partials, gram) in refs.items():
        for r in range(W):
            got = ranks[r][kind, agg]
            want = torch.cat(partials, 1).numpy()
            np.testing.assert_allclose(got["partials"], want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
            if agg == "krum":
                np.testing.assert_allclose(
                    got["gram"], gram.numpy(), rtol=1e-5,
                    atol=1e-5 * np.abs(gram.numpy()).max())


@pytest.mark.parametrize("name", sorted(POD_CASES))
def test_pod_step_w2_matches_w1(ranks, name):
    ref = _pod_run(POD_CASES[name])
    for r in range(W):
        got = ranks[r]["pod", name]
        np.testing.assert_array_equal(got["team"], ref["team"])
        assert got["h"] == ref["h"]
        np.testing.assert_allclose(got["trust"], ref["trust"], atol=ATOL)
        for a, b in zip(tree.leaves(got["params"]),
                        tree.leaves(ref["params"])):
            np.testing.assert_allclose(a, b, atol=ATOL)
        for gm, rm in zip(got["metrics"], ref["metrics"]):
            for k in rm:
                np.testing.assert_allclose(
                    gm[k], rm[k], rtol=1e-5, err_msg=k,
                    atol=THETA_ATOL if k == "theta_team" else ATOL)


class _Mesh:
    """What JAX's ``client_flat_specs`` reads of a mesh: its shape."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


@pytest.mark.parametrize("data", [1, 2, 4])
@pytest.mark.parametrize("align", [1, QBLK])
def test_shard_flags_match_jax(data, align):
    sizes = [512, 301, 5, 256, 128, 4096, 8, 1024 * 3]
    mesh = mesh_mod.Mesh(("data", "model"), (data, 1), None, 0)
    got = specs.client_flat_specs(sizes, mesh, align=align)
    ref = jspecs.client_flat_specs(sizes, _Mesh(data, 1), align=align)
    assert got[1] == ref[1]
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in ref[0]]


def test_w1_matches_jax_aggregate_sharded():
    w, m = _wm()
    full = _tree()
    jtree = {k: jnp.asarray(v) for k, v in _np_tree().items()}
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    enc, layout, like = _record(full)
    jenc = jcodecs.make_codec(JFedConfig(compress="int8")).encode_tree(
        jax.tree_util.tree_map(lambda l: l.astype(jnp.float32), jtree))
    with mesh_mod.host_mesh(device="cpu") as mesh:
        for agg in AGGS:
            cfg, jcfg = (FedConfig(n_clients=C, aggregator=agg),
                         JFedConfig(n_clients=C, aggregator=agg))
            got = _np(aggregation.aggregate_sharded(full, w, m, cfg, mesh))
            ref = jaggregation.aggregate_sharded(
                jtree, jnp.asarray(w.numpy()), jnp.asarray(m.numpy()), jcfg,
                jmesh)
            _close(got, {k: np.asarray(v, np.float32)
                         for k, v in ref.items()})
            if agg in ("fedavg", "krum"):
                got = _np(dq.fused_dequant_aggregate_sharded(
                    enc, layout, w, m, cfg, mesh, like=like))
                ref = jdq.fused_dequant_aggregate_sharded(
                    jenc, jnp.asarray(w.numpy()), jnp.asarray(m.numpy()),
                    jcfg, jmesh, like=jtree)
                _close(got, {k: np.asarray(v, np.float32)
                             for k, v in ref.items()})
    # the port's record is JAX's per-leaf records side by side
    jrec = interop.wire_from_numpy(jax.tree_util.tree_map(np.asarray, jenc))
    assert torch.equal(jrec.q, enc.q) and torch.equal(jrec.s, enc.s)
