"""The sharded step partitioned as the reference's, on gloo meshes of
spawned processes (``tests/torch_pod_tp_cases.py``):

  * the MoE dispatch of a placed batch (``moe.placed_dispatch``: the routing
    keys gathered, one global sort on every rank) bitwise the plain
    ``dispatch`` of the whole batch, at 2 x 2 on a reduced granite whose
    capacity drops routed pairs; and its pod step (the rows dispatched and
    combined on the ranks that hold their slots) against the unsharded
    step at the pod tests' tolerances;
  * decode on a cache split on its sequence over "model": a placed prefill
    and 4 greedy decode steps on 1 x 2 and 1 x 4 meshes against the plain
    calls (logits within 1e-5 of their largest, the same tokens), for 4 q /
    2 kv heads (padded to 4 groups on 1 x 4) and 3 q / 1 kv heads (padded
    to 2 groups on 1 x 2); and the log-sum-exp combine alone
    (``attention._sdpa`` on keys split in 2 and 4) against
    ``attention._sdpa_local`` on the whole keys within 1e-5;
  * the per-client reshard's send layout (``collectives.ColumnShards``):
    rows written through ``views`` equal ``pack`` of the leaf-order rows,
    bitwise; and the pod step's dense aggregation (``aggregate_tp`` on the
    buffers its per-client backward wrote) makes no leaf-sized copy
    (``copy_lint`` strict, on a fake group).
"""
import numpy as np
import pytest
import torch

import torch_pod_tp_cases as tp
from repro_torch.configs.base import FedConfig
from repro_torch.models import attention, moe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    return tp.spawn((2, 2), [("dispatch", None), ("moe_drop", "none"),
                             ("moe_drop", "fedavg")],
                    str(tmp_path_factory.mktemp("faults")))


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory):
    return tp.spawn((1, 2), [("greedy", "attn"), ("greedy", "attn_uneven"),
                             ("lse", None)],
                    str(tmp_path_factory.mktemp("faults")))


@pytest.fixture(scope="module")
def mesh_1x4(tmp_path_factory):
    return tp.spawn((1, 4), [("greedy", "attn"), ("lse", None)],
                    str(tmp_path_factory.mktemp("faults")))


def test_placed_dispatch_is_the_global_dispatch_bitwise(mesh_2x2):
    keys = tp.dispatch_keys()
    cfg = tp.KINDS["moe_drop"]
    ref = [t.numpy() for t in moe.dispatch(keys, keys.shape[0], cfg)]
    assert not ref[2].all(), "the case must drop routed pairs"
    for r in mesh_2x2:
        for got, want, name in zip(mesh_2x2[r]["dispatch", None], ref,
                                   ("order", "tok", "keep", "dest")):
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("case", ["none", "fedavg"])
def test_placed_moe_step_with_drops_matches_unsharded(mesh_2x2, case):
    ref = tp.run("moe_drop", case)
    for r in mesh_2x2:
        tp.check(mesh_2x2[r]["moe_drop", case], ref)


def _check_greedy(ranks, kind):
    ref_logits, ref_tokens = tp.run_greedy(kind)
    for r in ranks:
        logits, tokens = ranks[r]["greedy", kind]
        np.testing.assert_array_equal(tokens, ref_tokens)
        assert len(logits) == tp.DECODE_STEPS + 1
        tp.check_serve(logits, ref_logits)


@pytest.mark.parametrize("kind", ["attn", "attn_uneven"])
def test_decode_on_a_sequence_split_cache_1x2(mesh_1x2, kind):
    _check_greedy(mesh_1x2, kind)


def test_decode_on_a_sequence_split_cache_1x4(mesh_1x4):
    _check_greedy(mesh_1x4, "attn")


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_lse_combine_matches_sdpa_local(mesh_1x2, mesh_1x4, mesh):
    ranks = {"1x2": mesh_1x2, "1x4": mesh_1x4}[mesh]
    q, k, v, mask = tp.lse_inputs()
    ref = attention._sdpa_local(q, k, v, mask).numpy()
    for r in ranks:
        np.testing.assert_allclose(ranks[r]["lse", None], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


# sizes: a split leaf, a split leaf whose columns straddle rank blocks in
# the concatenated layout, and two leaves that stay whole
LEAVES = (64, 96, 7, 5)


def _shards(w):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import collectives, specs
    mesh = Mesh(("data",), (w,), None, 0)
    _, flags = specs.client_flat_specs(LEAVES, mesh, ("data",))
    return collectives.ColumnShards(LEAVES, flags, mesh)


@pytest.mark.parametrize("span", [(0, 172), (10, 100), (60, 40), (150, 22),
                                  (165, 7)])
@pytest.mark.parametrize("w", [1, 2, 4])
def test_send_layout_views_equal_pack(w, span):
    """Rows written piece by piece through ``ColumnShards.views`` (as the
    pod step writes each leaf's grads) equal ``pack`` of the leaf-order
    rows, for column ranges inside a leaf, across leaves and across rank
    blocks; the whole concatenated row as one matrix (``aggregate_tp``'s
    layout) alike."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import collectives, specs
    rng = np.random.default_rng(w)
    r, n = 3, sum(LEAVES)
    x = torch.from_numpy(rng.standard_normal((r, n)).astype(np.float32))
    for cols in (_shards(w), None):
        if cols is None:            # one matrix: n - n % W split, rest whole
            mesh = Mesh(("data",), (w,), None, 0)
            sizes = [s for s in (n - n % w, n % w) if s]
            _, flags = specs.client_flat_specs(sizes, mesh, ("data",))
            cols = collectives.ColumnShards(sizes, flags, mesh)
        want = cols.pack(x)
        got = cols.empty(r, x.device)
        got.send.zero_()
        got.rep.zero_()
        a, m = span
        pieces = [(0, a), (a, m), (a + m, n - a - m)]
        for c in range(r):
            for lo, width in pieces:
                g = x[c, lo:lo + width]
                for dst, s, e in cols.views(got, c, lo, width):
                    dst.copy_(g[s:e].view(dst.shape))
        torch.testing.assert_close(got.send, want.send, rtol=0, atol=0)
        torch.testing.assert_close(got.rep, want.rep, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_pod_step_reshard_makes_no_leaf_sized_copy(shape):
    """The per-client pod step's dense aggregation, as the step calls it:
    ``aggregation.aggregate_tp`` on the ``SendRows`` its ``client_grads``
    wrote, recorded from one step of tiny-lm (small widths, C = 4) over a
    fake group, then audited by ``copy_lint`` strict with the smallest
    leaf's C/D rows as the threshold: the reshard sends the buffers the
    backward wrote, with no packing copy, and the all_to_all stays."""
    from repro_torch import tree
    from repro_torch.analysis import entrypoints as ep
    from repro_torch.analysis import lint
    from repro_torch.analysis.rules import RULES
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.core import aggregation
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer
    from repro_torch.sharding import collectives
    cfg = get_config("tiny-lm").reduced()
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg)
    calls = []
    real = aggregation.aggregate_tp

    def spy(*args):
        calls.append(args)
        return real(*args)

    with mesh_mod.fake_group(shape[0] * shape[1]):
        m = mesh_mod.make_grid_mesh(shape, ("data", "model"))
        state, batch, step = dryrun.train_setup(
            cfg, InputShape("t", 64, 8, "train"), m, params, n_clients=4,
            robust="per_client")
        aggregation.aggregate_tp = spy
        try:
            step(state, batch)
        finally:
            aggregation.aggregate_tp = real
        assert len(calls) == 1
        split, whole, w, team, fed, mesh = calls[0]
        assert all(isinstance(x, collectives.SendRows)
                   for x in (split, whole))
        rows = 4 // shape[0]
        threshold = rows * min(x.numel() for x in tree.leaves(params))
        ctx = lint.run_target("pod_reshard", ep.Target(
            lambda *a: real(*a, fed, mesh),
            (split, whole, w.clone(), team.clone()),
            copy_mode="strict", copy_threshold=threshold),
            torch.device("cpu"))
        RULES["copy_lint"].fn(ctx)
        found = [f for f in ctx.result.findings if f.rule == "copy_lint"]
        # the twin: the same rows in leaf order are packed, a copy the
        # rule sees
        n = aggregation._width(whole)
        twin = lint.run_target("pod_reshard_packed", ep.Target(
            lambda x, w_, t_: real(split, aggregation.tp_columns(
                n, mesh).pack(x), w_, t_, fed, mesh),
            (torch.randn(rows, n), w.clone(), team.clone()),
            copy_mode="strict", copy_threshold=threshold),
            torch.device("cpu"))
        RULES["copy_lint"].fn(twin)
    assert not found, [f.message for f in found]
    assert [f for f in twin.result.findings if f.rule == "copy_lint"]
    # the all_to_all stays: the least traffic that makes column shards
    assert ctx.log.collectives["all-to-all"] > 0


@pytest.mark.parametrize("pieces", [3, 4])
def test_padded_heads_compute_the_unpadded_attention(pieces):
    """Attention run in heads padded as an uneven split over ``pieces``
    ranks pads them (zero q heads, each q head with its own copy of its kv
    head; ``attention.heads``), here on plain tensors: the output and the
    grads of x and of every weight equal the unpadded call's within 1e-6
    of their largest."""
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["tiny-lm"].reduced().replace(n_heads=4, n_kv_heads=2)
    g = torch.Generator().manual_seed(0)
    params = {k: v.requires_grad_() for k, v in
              attention.init_attention(g, cfg).items()}
    x = torch.randn(2, 8, cfg.d_model, generator=g, requires_grad=True)
    pos = torch.arange(8)[None].expand(2, 8)
    hd = attention.heads(params, cfg, pieces)
    assert hd.hp % pieces == 0 and hd.kv is not None

    def run(hd):
        out, _ = attention.attention_fwd(params, x, cfg, pos, hd=hd)
        grads = torch.autograd.grad((out * out).sum(),
                                    [x, *params.values()])
        return [out, *grads]

    for got, want in zip(run(hd), run(None)):
        scale = float(want.detach().abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("blocks", [(1, 1), (2, 1), (1, 2), (4, 2)])
def test_slot_combine_over_blocks_sums_to_the_plain_combine(blocks):
    """The placed MoE's combine (``moe._slot_combine``: each rank's block of
    the (E, C) slots, ``blocks`` = (expert blocks, capacity blocks), its
    weighted rows added into an (N, d) partial) summed over the blocks
    equals the plain path's ``moe._combine`` within 1e-6 of its largest,
    on the dropping config's skewed routing; so does the grad of the
    expert rows."""
    cfg = tp.KINDS["moe_drop"]
    keys = tp.dispatch_keys()
    N, K, E, d = keys.shape[0], cfg.top_k, cfg.n_experts, 16
    C = moe._capacity(N, cfg)
    g = torch.Generator().manual_seed(0)
    eo = torch.randn(E, C, d, generator=g, requires_grad=True)
    top_p = torch.rand(N, K, generator=g)
    order, tok, _, start, _, keep, dest = moe._dispatch_parts(keys, N, cfg)
    assert not bool(keep.all())
    want = moe._combine(eo, top_p, order, keep, dest, N, cfg)
    got = 0
    (be, bc) = blocks
    for i in range(be):
        for j in range(bc):
            en, cn = E // be, C // bc
            at, held, rows = moe._slot_map(start, tok, N, K, (i * en, en),
                                           (j * cn, cn))
            blk = eo[i * en:(i + 1) * en, j * cn:(j + 1) * cn]
            w = top_p.reshape(-1)[order[at]]
            got = got + moe._slot_combine(blk.reshape(-1, d), w, held,
                                          rows, N)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * scale)
    cot = torch.randn(N, d, generator=g)
    g_got, = torch.autograd.grad((got * cot).sum(), eo)
    g_want, = torch.autograd.grad((want * cot).sum(), eo)
    torch.testing.assert_close(g_got, g_want, rtol=0,
                               atol=1e-6 * float(g_want.abs().max()))


def _drop_row_combine(eo, top_p, order, keep, dest, N, cfg):
    """The plain combine as it read dropped pairs before: every one from a
    shared zero row appended to the buffer."""
    d = eo.shape[-1]
    eo = torch.cat([eo.reshape(-1, d), eo.new_zeros((1, d))], dim=0)
    w = (top_p.reshape(-1)[order] * keep).to(eo.dtype)
    gathered = eo[dest] * w[:, None]
    return gathered[torch.argsort(order)].reshape(N, cfg.top_k, d).sum(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_combine_is_bitwise_the_drop_row_combine(dtype):
    """``moe._combine`` reads each dropped pair from a row of its own,
    masked to 0: its output and the grads of the expert rows and of the
    routing weights are bitwise those of the shared drop row, on the
    dropping config's skewed routing."""
    cfg = tp.KINDS["moe_drop"]
    keys = tp.dispatch_keys()
    N, K, E, d = keys.shape[0], cfg.top_k, cfg.n_experts, 16
    C = moe._capacity(N, cfg)
    g = torch.Generator().manual_seed(0)
    eo = torch.randn(E, C, d, generator=g).to(dtype).requires_grad_()
    top_p = torch.rand(N, K, generator=g).requires_grad_()
    order, _, keep, dest = moe.dispatch(keys, N, cfg)
    assert not bool(keep.all())
    cot = torch.randn(N, d, generator=g).to(dtype)
    outs = []
    for fn in (moe._combine, _drop_row_combine):
        out = fn(eo, top_p, order, keep, dest, N, cfg)
        outs.append([out, *torch.autograd.grad((out * cot).sum(),
                                               [eo, top_p])])
    for got, want in zip(*outs):
        assert torch.equal(got, want)
