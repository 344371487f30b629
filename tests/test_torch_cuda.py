"""The port on the card: each CUDA kernel against its plain version (and
K6a-c bitwise against K1-K3 on the masked decode, K5 bitwise against K2's
rank modes, the flat wrappers K4a-c bitwise against K1-K3, K7's candidates
bitwise against ``block_topd_plain`` and its fused stage 2 bitwise against
the CPU path's merge), the Gram kernels K3 and K6c past 64
rows, the combine family (K2, K4b, K5, K6b) and the pass-1 family (K1,
K4a, K6a) at every register bucket, the shared tile and each alignment of
N (pass 1 also on unaligned views, and with non-finite rows), the
attention kernels K8 (paged flash-decode, with slots ending in every split, two calls bitwise equal)
and K9 (flash attention), the wrappers' checks and launch counts, a round on the card
(dense, int8 and buffered-async) against the same round on the CPU, and
the tiny-lm serving engine on the card against the CPU port's tokens.
Needs a CUDA device; skips without one.  Imports no jax, so it runs where
only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the median bitwise; per-column sums over clients rtol 1e-5 /
atol 1e-6; sums over ~6.5e4 columns (cosine partials, Gram) at 1e-5 of
the largest magnitude, because the kernel and torch reduce in other
orders.  K8 within 2e-5 of its plain version (fp32 sums over up to 384
keys in other chunkings); K9 in fp32 within 1e-5, in bf16 within one bf16
ulp of the output plus 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.comm import codecs
from repro_torch.comm.kernels import comm_codecs as dq
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.configs.paper_models import MLP_CONFIG
from repro_torch.core import async_engine, fedfits, faults
from repro_torch.data.pipeline import build_federation
from repro_torch.configs.registry import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import pass1_checks
from repro_torch.kernels import population_select as ps
from repro_torch.kernels import robust_agg as ra
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.kernels import topd_checks
from repro_torch.models.attention import _paged_quant
from repro_torch.models.model import build
from repro_torch.serve import ServeConfig, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(card, g=3, c=64, n=65573):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((g, c, n), np.float32)
    mask = np.ones((g, c), np.float32)
    mask[0, 5] = 0.0
    mask[1] = 0.0                                  # empty cohort
    mask[2] = 0.0
    mask[2, 7] = 1.0                               # one member
    w = mask / np.maximum(mask.sum(1, keepdims=True), 1.0)
    return (torch.from_numpy(a).to(card) for a in (x, mask, w))


def _close_rel(out, ref):
    tol = 1e-5 * float(ref.abs().max())
    assert float((out - ref).abs().max()) <= tol


def test_kernels_match_plain(card):
    x, m, w = _inputs(card)
    for o, r in zip(rp.cosine_gate_partials(x, m),
                    rp.cosine_gate_partials_plain(x, m)):
        _close_rel(o, r)
    for mode in rp.MODES:
        out = rp.gated_combine(x, m, w, mode=mode)
        ref = rp.gated_combine_plain(x, m, w, mode=mode)
        if mode == "median":
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        assert float(out[1].abs().max()) == 0.0
        torch.testing.assert_close(out[2], x[2, 7], rtol=1e-5, atol=1e-6)
    _close_rel(rp.pairwise_gram(x), rp.pairwise_gram_plain(x))


def test_wrappers_check_and_count(card):
    x, m, w = _inputs(card, c=8, n=1000)
    rp.reset_launch_counts()
    rp.fused_pipeline(x, w, m, aggregator="krum")
    assert rp.launch_counts() == {
        "cosine_gate_partials": 1, "pairwise_gram": 1,
        "gated_combine[mean]": 1, "gated_combine[trimmed]": 0,
        "gated_combine[median]": 0}
    with pytest.raises(TypeError):
        rp.cosine_gate_partials(x.double(), m)
    with pytest.raises(ValueError):
        rp.gated_combine(x.transpose(1, 2), m, w, mode="mean")
    with pytest.raises(ValueError):
        rp.pairwise_gram(torch.zeros(1, 10, 65, device=card).transpose(1, 2))


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean", "krum"])
def test_round_on_card_matches_cpu(card, aggregator):
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    cfg = FedConfig(n_clients=6, local_epochs=2, local_lr=0.05, msl=4,
                    pft=2, aggregator=aggregator)
    fed, _ = build_federation(0, n=600, n_clients=6, batch_size=16)
    params = model.init(torch.Generator(card).manual_seed(0))
    cpu = lambda t: tree.map(lambda v: v.cpu(), t)
    s_gpu = fedfits.init_state(params, 6, cfg, torch.Generator(card))
    s_cpu = fedfits.init_state(cpu(params), 6, cfg, torch.Generator())
    f = fedfits.make_round(model, cfg)
    gen = torch.Generator(card).manual_seed(1)
    for t in range(3):
        batch = fed.data_fn(t + 1, gen)
        s_gpu, m_gpu = f(s_gpu, batch)
        s_cpu, m_cpu = f(s_cpu, cpu(batch))
        assert torch.equal(m_gpu["team"].cpu(), m_cpu["team"])
        for a, b in zip(tree.leaves(s_gpu.params), tree.leaves(s_cpu.params)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)


WIDE_LEAVES = (1000, 33, 64000, 540)


def _quant(card):
    """int8 codes and scales of ``_inputs``' matrix over 4 ragged leaves,
    by the port's own codec."""
    x, m, w = _inputs(card)
    g, c, n = x.shape
    layout = codecs.WireLayout(WIDE_LEAVES, 128)
    enc = codecs.Codec("int8").encode_flat(x.reshape(g * c, n) * 1e-2, layout)
    return enc.q.view(g, c, n), enc.s.view(g, c, -1), layout, m, w


def _bitwise(out, ref):
    same = (out.view(torch.int32) == ref.view(torch.int32)) \
        | (out.isnan() & ref.isnan())
    assert bool(same.all())


def test_dequant_kernels_match_plain(card):
    q, s, layout, m, w = _quant(card)
    for o, r in zip(dq.dequant_gate_partials(q, s, layout, m),
                    dq.dequant_gate_partials_plain(q, s, layout, m)):
        _close_rel(o, r)
    for mode in rp.MODES:
        out = dq.dequant_gated_combine(q, s, layout, m, w, mode=mode)
        ref = dq.dequant_gated_combine_plain(q, s, layout, m, w, mode=mode)
        if mode == "median":
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        assert float(out[1].abs().max()) == 0.0
    _close_rel(dq.dequant_pairwise_gram(q, s, layout, m),
               dq.dequant_pairwise_gram_plain(q, s, layout, m))


def test_dequant_kernels_are_k1_k3_on_the_masked_decode(card):
    q, s, layout, m, w = _quant(card)
    xm = dq.dequant_masked(q, s, layout, m)
    for o, r in zip(dq.dequant_gate_partials(q, s, layout, m),
                    rp.cosine_gate_partials(xm, m)):
        _bitwise(o, r)
    for mode in rp.MODES:
        _bitwise(dq.dequant_gated_combine(q, s, layout, m, w, mode=mode),
                 rp.gated_combine(xm, m, w, mode=mode))
    _bitwise(dq.dequant_pairwise_gram(q, s, layout, m), rp.pairwise_gram(xm))


def test_dequant_wrappers_check_and_count(card):
    q, s, layout, m, w = _quant(card)
    dq.reset_launch_counts()
    dq.fused_dequant_pipeline(q, s, layout, w, m, aggregator="krum")
    assert dq.launch_counts() == {
        "dequant_gate_partials": 1, "dequant_pairwise_gram": 1,
        "dequant_gated_combine[mean]": 1, "dequant_gated_combine[trimmed]": 0,
        "dequant_gated_combine[median]": 0}
    with pytest.raises(TypeError):
        dq.dequant_gate_partials(q.to(torch.int16), s, layout, m)
    with pytest.raises(TypeError):
        dq.dequant_gated_combine(q, s.double(), layout, m, w, mode="mean")
    with pytest.raises(ValueError):
        dq.dequant_pairwise_gram(q[:, :, :-1].contiguous(), s, layout, m)


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
def test_int8_round_on_card_matches_cpu(card, aggregator):
    """3 int8 rounds: the same team, params within one quantisation step
    (the round's largest scale): card and CPU updates differ at ~1e-8,
    enough to flip a code at a rounding tie."""
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    cfg = FedConfig(n_clients=6, local_epochs=2, local_lr=0.05, msl=4,
                    pft=2, aggregator=aggregator, compress="int8")
    fed, _ = build_federation(0, n=600, n_clients=6, batch_size=16)
    params = model.init(torch.Generator(card).manual_seed(0))
    cpu = lambda t: tree.map(lambda v: v.cpu(), t)
    s_gpu = fedfits.init_state(params, 6, cfg, torch.Generator(card))
    s_cpu = fedfits.init_state(cpu(params), 6, cfg, torch.Generator())
    f = fedfits.make_round(model, cfg)
    client_update = fedfits.make_client_update(model, cfg)
    gen = torch.Generator(card).manual_seed(1)
    dq.reset_launch_counts()
    for t in range(3):
        batch = fed.data_fn(t + 1, gen)
        local, _ = client_update(s_cpu.params, cpu(batch))
        target = torch.cat([(a - b).reshape(6, -1) for a, b in zip(
            tree.leaves(local), tree.leaves(s_cpu.params))], 1) \
            + s_cpu.clients.ef
        step = float(target.abs().max()) / 127.0
        s_gpu, m_gpu = f(s_gpu, batch)
        s_cpu, m_cpu = f(s_cpu, cpu(batch))
        assert torch.equal(m_gpu["team"].cpu(), m_cpu["team"])
        for a, b in zip(tree.leaves(s_gpu.params), tree.leaves(s_cpu.params)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=step + 1e-5)
    assert dq.launch_counts()["dequant_gate_partials"] == 3


@pytest.mark.parametrize("label,m,d,blk,kind", topd_checks.CASES)
def test_block_topd_matches_plain(card, label, m, d, blk, kind):
    """K7's candidates bitwise ``block_topd_plain``'s, one launch a call,
    over ``topd_checks.CASES``: Gumbel keys at the async path's and the
    reference's shapes, ragged and exhausted blocks, M = 4,097, d = 1,
    1,024 and blk, duplicates, +-0.0 mixtures, all-equal blocks, exactly d
    finite keys a block, and unaligned views; where no signed zero or
    exhausted tail reaches the top-d, every route gives argsort's order."""
    g = topd_checks.keys(m, d, blk, kind, m + d, card)
    assert topd_checks.candidates(g, d, blk) == 0.0
    if kind in topd_checks.ARGSORT_KINDS:
        topd_checks.every_route(g, d, blk)


@pytest.mark.parametrize("label,m,d,blk,kind", topd_checks.CASES)
def test_fused_topd_matches_cpu_path(card, label, m, d, blk, kind):
    """The fused launch (``topd_pallas`` on the unpadded keys: stage 1 and
    the merge in one launch) gives bitwise the (d,) indices of the CPU path
    (``block_topd_plain`` then ``_merge``) on the same keys, launching K7
    once a call; two calls agree, the completion counter left at 0."""
    g = topd_checks.keys(m, d, blk, kind, m + d, card)
    out = topd_checks.fused(g, d, blk)
    assert torch.equal(topd_checks.fused(g, d, blk), out)
    assert all(int(c) == 0 for c in ps._COUNTERS.values())


def test_block_topd_wrapper_checks_and_routes(card):
    g = torch.randn(40, device=card)
    ps.reset_launch_counts()
    out = ps.topd(g, 64, method="pallas")          # d >= M: argsort route
    assert out.shape == (40,) and ps.launch_counts()["block_topd"] == 0
    ps.topd(torch.randn(5000, device=card), 8, method="segmented")
    assert ps.launch_counts()["block_topd"] == 0
    with pytest.raises(TypeError):
        ps.block_topd(torch.zeros(4096, device=card, dtype=torch.float64),
                      4, 4096)
    with pytest.raises(ValueError):
        ps.block_topd(torch.zeros(4000, device=card), 4, 4096)


def test_async_round_on_card_matches_cpu(card):
    """3 buffered-async rounds of paper-mlp (M=24, C=8) with chronic
    stragglers, the card's draws copied to the CPU: the same cohorts,
    on-time masks and buffer state, params within 1e-5."""
    model = build(MLP_CONFIG)
    cfg = FedConfig(n_clients=8, population=24, algorithm="fedavg",
                    local_epochs=1, local_lr=0.2, aggregator="trimmed_mean",
                    select_method="pallas")
    fl = faults.FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                            base_delay=0.3)
    fed, _ = build_federation(0, kind="tabular", n=600, n_clients=24,
                              batch_size=16, n_classes=10, sep=1.0,
                              dirichlet_alpha=1.0)
    cpu = lambda t: tree.map(lambda v: v.cpu(), t)
    params = model.init(torch.Generator(card).manual_seed(0))
    s_gpu = async_engine.init_async_state(
        params, cfg, torch.Generator(card).manual_seed(1))
    s_cpu = async_engine.init_async_state(cpu(params), cfg,
                                          torch.Generator())
    draw, f_gpu = async_engine.make_async_round(model, cfg, fed.data,
                                                batch_size=16, faults=fl)
    _, f_cpu = async_engine.make_async_round(model, cfg, cpu(fed.data),
                                             batch_size=16, faults=fl)
    ps.reset_launch_counts()
    for t in range(3):
        draws = draw(s_gpu)
        s_gpu, m_gpu = f_gpu(s_gpu, draws)
        s_cpu, m_cpu = f_cpu(s_cpu, cpu(draws))
        for k in ("cohort", "on_time", "due", "exhausted"):
            assert torch.equal(m_gpu[k].cpu(), m_cpu[k]), (k, t)
        for k in ("owner", "age", "active"):
            assert torch.equal(getattr(s_gpu.buf, k).cpu(),
                               getattr(s_cpu.buf, k)), (k, t)
        for a, b in zip(tree.leaves(s_gpu.params), tree.leaves(s_cpu.params)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    assert ps.launch_counts()["block_topd"] == 3


@pytest.mark.parametrize("c", [96, 130])
def test_gram_kernels_past_64_rows(card, c):
    """K3 and K6c over several 64 x 64 output tiles (C = 130: a ragged
    last tile) and a ragged N, against their plain versions; K6c bitwise
    K3 on the masked decode."""
    rng = np.random.default_rng(c)
    n = 20_011
    x = torch.from_numpy(rng.standard_normal((2, c, n), np.float32)).to(card)
    _close_rel(rp.pairwise_gram(x), rp.pairwise_gram_plain(x))
    m = torch.ones(2, c, device=card)
    m[1, ::7] = 0.0
    layout = codecs.WireLayout((7_000, 13_011), 128)
    enc = codecs.Codec("int8").encode_flat(x.reshape(2 * c, n) * 1e-2,
                                           layout)
    q, sc = enc.q.view(2, c, n), enc.s.view(2, c, -1)
    out = dq.dequant_pairwise_gram(q, sc, layout, m)
    _close_rel(out, dq.dequant_pairwise_gram_plain(q, sc, layout, m))
    _bitwise(out, rp.pairwise_gram(dq.dequant_masked(q, sc, layout, m)))


def test_robust_agg_fwd_matches_plain_and_k2(card):
    """K5 in both modes under full, mixed, one-member and empty masks:
    the median bitwise its plain version, the trimmed mean within rtol
    1e-5; bitwise K2 under the same mask; exactly 0 for an empty mask."""
    rng = np.random.default_rng(5)
    c, n = 17, 70_001
    x = torch.from_numpy(rng.standard_normal((c, n), np.float32)).to(card)
    masks = {"full": torch.ones(c), "mixed": (torch.arange(c) % 3 > 0),
             "one": torch.arange(c) == 7, "empty": torch.zeros(c)}
    ra.reset_launch_counts()
    for kind, m in masks.items():
        m = m.float().to(card)
        for mode in ra.MODES:
            out = ra.robust_agg_fwd(x, m, mode=mode)
            ref = ra.robust_agg_fwd_plain(x, m, mode=mode)
            if mode == "median":
                assert torch.equal(out, ref), kind
            else:
                torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
            _bitwise(out, rp.gated_combine(x[None], m[None], m[None],
                                           mode=mode)[0])
            if kind == "empty":
                assert float(out.abs().max()) == 0.0
            if kind == "one":
                assert torch.equal(out, x[7])
    assert ra.launch_counts() == {"robust_agg_fwd[trimmed]": 4,
                                  "robust_agg_fwd[median]": 4}
    with pytest.raises(TypeError):
        ra.robust_agg_fwd(x.double(), m)
    with pytest.raises(ValueError):
        ra.robust_agg_fwd(x, m, mode="mean")


@pytest.mark.parametrize("widths", [[1000, 1, 777, 2048, 273],
                                    [1000, 2, 776, 2048, 270]])
@pytest.mark.parametrize("c", [16, 40, 96])
def test_segment_table_is_bitwise_the_concatenation(card, c, widths):
    """K1-K3 over a tree's leaves side by side (``rp_*_seg``: leaves of
    odd and even widths, one or two columns wide among them, so a thread's
    columns straddle leaves and rows change alignment) give the dense entry
    points' results on their concatenation bit for bit, in every pass-1 and
    combine path (the 16-row bucket with one and two columns a thread, four
    a thread in the mean, 64 rows, the shared tile), and a launch through
    the table replays in a CUDA graph."""
    x, m, w = _inputs(card, c=c, n=sum(widths))
    leaves = [l.contiguous() for l in torch.split(x, widths, dim=-1)]
    for o, r in zip(rp.cosine_gate_partials(leaves, m),
                    rp.cosine_gate_partials(x, m)):
        _bitwise(o, r)
    for mode in rp.MODES:
        _bitwise(rp.gated_combine(leaves, m, w, mode=mode),
                 rp.gated_combine(x, m, w, mode=mode))
    _bitwise(rp.pairwise_gram(leaves), rp.pairwise_gram(x))
    torch.cuda.synchronize()
    ref = rp.gated_combine(x, m, w, mode="trimmed")
    out = rp.gated_combine(leaves, m, w, mode="trimmed")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rp.gated_combine(leaves, m, w, mode="trimmed")
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    _bitwise(out, ref)


def test_flat_wrappers_are_bitwise_k1_k3(card):
    """K4a-c are K1-K3's entry points behind their own counters: the flat
    pipeline, the flat tree wrapper and the two-stage flat path give K1-K3's
    results bit for bit, and count apart."""
    x, m, w = _inputs(card)
    rp.reset_launch_counts()
    for agg in ("fedavg", "trimmed_mean", "median", "krum"):
        _bitwise(rp.fused_pipeline(x, w, m, aggregator=agg, flat=True),
                 rp.fused_pipeline(x, w, m, aggregator=agg))
    _bitwise(rp.pairwise_sq_dists_blocked(x, m), rp.pairwise_sq_dists(x, m))
    flat = rp.flat_launch_counts()
    assert flat == {"cosine_gate_partials_flat": 4,
                    "pairwise_sq_dists_blocked": 2,
                    "gated_combine_flat[mean]": 2,
                    "gated_combine_flat[trimmed]": 1,
                    "gated_combine_flat[median]": 1}
    assert rp.launch_counts()["cosine_gate_partials"] == 4
    cfg = FedConfig(n_clients=64, aggregator="trimmed_mean")
    upd = {"a": x[0, :, :1000].reshape(64, 10, 100), "b": x[0, :, 1000:]}
    for o, r in zip(tree.leaves(rp.fused_aggregate_tree_flat(upd, w[0], m[0],
                                                             cfg)),
                    tree.leaves(rp.fused_aggregate_tree(upd, w[0], m[0],
                                                        cfg))):
        _bitwise(o, r)
    slot = {"a": x[:2, :, :1000].reshape(2, 64, 10, 100),
            "b": x[:2, :, 1000:]}
    for o, r in zip(tree.leaves(rp.fused_two_stage_tree_flat(
                        slot, w[:2], m[:2], cfg)),
                    tree.leaves(rp.fused_two_stage_tree(slot, w[:2], m[:2],
                                                        cfg))):
        _bitwise(o, r)


def _paged(card, s=6, maxp=5, page=16, hq=24, hkv=8, dh=128, seed=0):
    rng = np.random.default_rng(seed)
    n = s * maxp + 2
    q = torch.from_numpy(rng.standard_normal((s, hq, dh), np.float32))
    kp = torch.from_numpy(rng.standard_normal((n, page, hkv, dh),
                                              np.float32))
    vp = torch.from_numpy(rng.standard_normal((n, page, hkv, dh),
                                              np.float32))
    table = torch.from_numpy(rng.permutation(n)[:s * maxp]
                             .reshape(s, maxp).astype(np.int32))
    lengths = torch.tensor([maxp * page, page + 1, 1, 0]
                           + [maxp * page - 3] * (s - 4), dtype=torch.int32)
    return [t.to(card) for t in (q, kp, vp, table, lengths)]


@pytest.mark.parametrize("page,hq,hkv,dh", [(16, 24, 8, 128), (8, 8, 4, 64),
                                            (32, 8, 4, 64)])
def test_paged_decode_matches_plain(card, page, hq, hkv, dh):
    """K8 with fp32 and int8 pools, fp32 and bf16 queries: every page full,
    page + 1 rows, one row, an inactive slot (exactly 0)."""
    q, kp, vp, table, lengths = _paged(card, page=page, hq=hq, hkv=hkv,
                                       dh=dh)
    kq, ks = _paged_quant(kp)
    vq, vs = _paged_quant(vp)
    for qx in (q, q.bfloat16()):
        for pools, sc in (((kp, vp), {}),
                          ((kq, vq), dict(k_scale=ks, v_scale=vs))):
            out = pd.paged_flash_decode(qx, *pools, table, lengths, **sc)
            ref = pd.paged_flash_decode_plain(qx, *pools, table, lengths,
                                              **sc)
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
            assert float(out[3].abs().max()) == 0.0


def test_paged_decode_wrapper_checks_and_counts(card):
    q, kp, vp, table, lengths = _paged(card, s=5)
    pd.reset_launch_counts()
    pd.paged_flash_decode(q, kp, vp, table, lengths)
    kq, ks = _paged_quant(kp)
    pd.paged_flash_decode(q, kq, _paged_quant(vp)[0], table, lengths,
                          k_scale=ks, v_scale=ks)
    assert pd.launch_counts() == {"paged_flash_decode": 1,
                                  "paged_flash_decode[int8]": 1}
    with pytest.raises(TypeError):
        pd.paged_flash_decode(q.half(), kp, vp, table, lengths)
    with pytest.raises(TypeError):
        pd.paged_flash_decode(q, kp.double(), vp.double(), table, lengths)
    with pytest.raises(TypeError):
        pd.paged_flash_decode(q, kp, vp, table.long(), lengths)
    with pytest.raises(ValueError):
        pd.paged_flash_decode(q, kp, vp, table, lengths[:3])
    assert sum(pd.launch_counts().values()) == 2


def _split_case(card, g, dh, page, hkv=1, s=40, keys=512, seed=0):
    """Pools, a permuted table and lengths that end in every work item a
    slot can have (``decode_splits`` at this card's SM count), at an
    item's first key and at its last, plus an inactive slot (slot 0)."""
    maxp = keys // page
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    splits, chunk, _ = pd.decode_splits(maxp, page, sms, s, hkv)
    assert s >= 2 * splits + 1
    rng = np.random.default_rng(seed)
    n = s * maxp + 2
    hq = g * hkv
    q = rng.standard_normal((s, hq, dh), np.float32)
    kp = rng.standard_normal((n, page, hkv, dh), np.float32)
    vp = rng.standard_normal((n, page, hkv, dh), np.float32)
    table = rng.permutation(n)[:s * maxp].reshape(s, maxp).astype(np.int32)
    ends = [0] + [k * chunk + 1 for k in range(splits)] \
        + [min((k + 1) * chunk, keys) for k in range(splits)]
    ends += list(rng.integers(1, keys + 1, s - len(ends)))
    lengths = np.asarray(ends, np.int32)
    return [torch.from_numpy(a).to(card)
            for a in (q, kp, vp, table, lengths)] + [splits]


@pytest.mark.parametrize("page", [1, 16, 32])
@pytest.mark.parametrize("g,dh", [(3, 128), (1, 256), (8, 64), (12, 64),
                                  (2, 50), (3, 51)])
def test_paged_decode_every_split_count(card, g, dh, page):
    """K8 against its plain version (atol 2e-5) with slots ending in each
    work item, on fp32 and int8 pools with fp32 and bf16 queries, the item
    counters back at 0 after each launch: the register row blocks of 1, 3
    and 8 rows (and two of 8 at g = 12), dh of 256,
    128, 64, 50 (char2 / float2 rows) and 51 (scalar rows), pages of 1,
    16 and 32; the inactive slot exactly 0."""
    q, kp, vp, table, lengths, splits = _split_case(card, g, dh, page)
    assert splits > 1
    kq, ks = _paged_quant(kp)
    vq, vs = _paged_quant(vp)
    for qx in (q, q.bfloat16()):
        for pools, sc in (((kp, vp), {}),
                          ((kq, vq), dict(k_scale=ks, v_scale=vs))):
            out = pd.paged_flash_decode(qx, *pools, table, lengths, **sc)
            ref = pd.paged_flash_decode_plain(qx, *pools, table, lengths,
                                              **sc)
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
            assert float(out[0].abs().max()) == 0.0
            assert int(pd._COUNTERS[q.device].abs().sum()) == 0


def test_paged_decode_calls_are_bitwise_equal(card):
    """The partials merge in a fixed order (warps, then items), so two
    calls on the same inputs give the same bits, on fp32 and int8 pools,
    at the serving shape and at one with 16 items a slot."""
    cases = [_paged(card, s=16, maxp=24)[:5],
             _split_case(card, 3, 128, 16)[:5]]
    for q, kp, vp, table, lengths in cases:
        kq, ks = _paged_quant(kp)
        vq, vs = _paged_quant(vp)
        for pools, sc in (((kp, vp), {}),
                          ((kq, vq), dict(k_scale=ks, v_scale=vs))):
            a = pd.paged_flash_decode(q.bfloat16(), *pools, table, lengths,
                                      **sc)
            b = pd.paged_flash_decode(q.bfloat16(), *pools, table, lengths,
                                      **sc)
            assert torch.equal(a, b)


@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
@pytest.mark.parametrize("c", [1, 16, 48, 96, 130])
def test_combine_family_every_bucket_and_alignment(card, c, nmod):
    """K2, K4b, K5 and K6b in each mode at C in {1, 16, 48, 96, 130} (the
    16, 64 register buckets and the shared tile) and N = 0, 1, 2, 3 mod 4
    (float4 / float2 / scalar rows): K2 and K6b against their plain
    versions (the median bitwise, sums rtol 1e-5), K4b and K5 bitwise K2,
    and K6b bitwise K2 on the masked decode over leaves whose boundaries
    cut a vector group (7,001 and 7,006) and whose quant blocks do too."""
    n = 20_000 + nmod
    rng = np.random.default_rng(c + nmod)
    x = torch.from_numpy(rng.standard_normal((2, c, n), np.float32) * 1e-2)
    m = torch.ones(2, c)
    m[0, ::3] = 0.0
    if c == 1:
        m[0] = 1.0
    w = m * torch.from_numpy(rng.uniform(0.1, 1.0, (2, c)).astype(np.float32))
    w = w / w.sum(1, keepdim=True)
    x, m, w = x.to(card), m.to(card), w.to(card)
    layout = codecs.WireLayout((7_001, 5, n - 7_006), 128)
    enc = codecs.Codec("int8").encode_flat(x.reshape(2 * c, n), layout)
    q, sc = enc.q.view(2, c, n), enc.s.view(2, c, -1)
    xm = dq.dequant_masked(q, sc, layout, m)
    for mode in rp.MODES:
        wm = w if mode == "mean" else m
        out = rp.gated_combine(x, m, wm, mode=mode)
        ref = rp.gated_combine_plain(x, m, wm, mode=mode)
        k6 = dq.dequant_gated_combine(q, sc, layout, m, wm, mode=mode)
        k6_ref = dq.dequant_gated_combine_plain(q, sc, layout, m, wm,
                                                mode=mode)
        if mode == "median":
            assert torch.equal(out, ref)
            assert torch.equal(k6, k6_ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(k6, k6_ref, rtol=1e-5, atol=1e-6)
        _bitwise(rp.gated_combine_flat(x, m, wm, mode=mode), out)
        _bitwise(k6, rp.gated_combine(xm, m, wm, mode=mode))
        if mode != "mean":
            _bitwise(ra.robust_agg_fwd(x[0], m[0], mode=mode), out[0])


@pytest.mark.parametrize("nmod", [0, 1, 2, 3])
@pytest.mark.parametrize("c", [1, 16, 17, 32, 33, 48, 64, 65, 130])
def test_pass1_family_every_bucket_and_alignment(card, c, nmod):
    """K1, K4a and K6a at C on both sides of each register bucket's edge
    (16, 32, 64) and past them (the shared tile), N = 0-3 mod 4 (2 columns
    a thread in the 16 bucket when N is even), with a masked-out row and
    ties, an empty cohort (zero partials) and a lone one: K1 and K6a
    within 1e-5 of the largest of their plain versions', K4a bitwise K1,
    K6a bitwise K1 on the masked decode, two calls of each bitwise equal;
    then on unaligned copies of x and of the codes, which keep the plan
    and so give the same bits (``pass1_checks.edge_case``)."""
    pass1_checks.edge_case(c, nmod, card)


@pytest.mark.parametrize("c", [16, 48, 130])
def test_pass1_family_with_nonfinite_rows(card, c):
    """A masked-out row of inf and a masked-in NaN
    (``pass1_checks.nonfinite``).  The dead row of inf is a departure from
    the plain versions and the JAX reference, not their semantics: those
    sum x times a 0/1 pick, so inf times 0 turns every median NaN, where
    the kernels select the median's rows (as K2 does) and stay finite
    (ROADMAP section 3).  So it is held to the kernel with that row
    zeroed: the live rows' partials and refsq bitwise, its own sqnorm inf,
    and in K6a its inf scales decode to 0 (held to the plain version).  A
    lone cohort whose member carries the NaN gives the plain version's
    NaNs and values; in a full cohort only the NaN's row is NaN.  Each
    stays repeatable and K6a bitwise K1 on the masked decode."""
    pass1_checks.nonfinite(c, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,dh,window", [(256, 128, 0), (256, 128, 64),
                                         (200, 64, 0), (200, 64, 64),
                                         (77, 128, 0)])
def test_flash_attention_matches_plain(card, dtype, S, dh, window):
    rng = np.random.default_rng(S + dh + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, S, dh),
                                                    np.float32))
               .to(card, dtype) for h in (6, 2, 2))
    out = fa.flash_attention_fwd(q, k, v, causal=True, window=window)
    ref = fa.flash_attention_fwd_plain(q, k, v, causal=True, window=window)
    assert out.dtype == dtype and out.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        o, r = out.float(), ref.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            r.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((o - r).abs() <= ulp + 1e-5).all())


def test_flash_attention_wrapper_checks_and_counts(card):
    q = torch.randn(1, 4, 130, 64, device=card)
    k = torch.randn(1, 2, 130, 64, device=card)
    fa.reset_launch_counts()
    out = fa.flash_attention_fwd(q, k, k, causal=True)
    # the model layout's transposed views go in without a copy
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(fa.flash_attention_fwd(qt, kt, kt), out,
                               atol=1e-6, rtol=0)
    assert fa.launch_counts() == {"flash_attention_fwd": 2}
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, k.bfloat16(), k)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(torch.randn(1, 4, 8, 320, device=card),
                               torch.randn(1, 2, 8, 320, device=card),
                               torch.randn(1, 2, 8, 320, device=card))
    assert fa.launch_counts() == {"flash_attention_fwd": 2}


def _k9_close(out, ref):
    """fp32 within 1e-5; bf16 within one bf16 ulp of the plain output plus
    1e-5 (the tolerances of test_flash_attention_matches_plain)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    if out.dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        o, r = out.float(), ref.float()
        ulp = torch.exp2(torch.floor(torch.log2(
            r.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((o - r).abs() <= ulp + 1e-5).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,dh,window", [(256, 256, 0), (200, 256, 64),
                                         (200, 72, 0), (130, 40, 64),
                                         (150, 192, 0), (200, 80, 64),
                                         (256, 96, 0)])
def test_flash_attention_other_head_dims_match_plain(card, dtype, S, dh,
                                                     window):
    """dh 256 (the tensor-core body's two-stage ring in bf16), dh 192, dh
    80 and 96 (a multiple of 16 but not of 64: the tensor-core body's
    partial 64-column chunk, zero-filled by TMA and cut by the store's
    column guard) and head dims that are not a multiple of 16 (the FMA
    body, in bf16 too)."""
    rng = np.random.default_rng(S + dh + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, S, dh),
                                                    np.float32))
               .to(card, dtype) for h in (4, 2, 2))
    _k9_close(fa.flash_attention_fwd(q, k, v, causal=True, window=window),
              fa.flash_attention_fwd_plain(q, k, v, causal=True,
                                           window=window))


def test_flash_attention_tensor_core_body_checks(card):
    """bf16 in the model layout goes in without a copy; a stride that is
    not a 16-byte multiple (TMA's rule) raises."""
    q = torch.randn(2, 256, 6, 64, device=card).bfloat16()
    kv = torch.randn(2, 256, 2, 64, device=card).bfloat16()
    fa.reset_launch_counts()
    out = fa.flash_attention_fwd(q.transpose(1, 2), kv.transpose(1, 2),
                                 kv.transpose(1, 2), window=64)
    _k9_close(out, fa.flash_attention_fwd_plain(
        q.transpose(1, 2).contiguous(), kv.transpose(1, 2).contiguous(),
        kv.transpose(1, 2).contiguous(), window=64))
    wide = torch.randn(1, 2, 128, 68, device=card).bfloat16()
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(wide[..., :64], wide[..., :64],
                               wide[..., :64])
    assert fa.launch_counts() == {"flash_attention_fwd": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_raises_under_grad_on_card(card, dtype):
    q = torch.randn(1, 2, 128, 64, device=card, dtype=dtype,
                    requires_grad=True)
    k = torch.randn(1, 1, 128, 64, device=card, dtype=dtype)
    fa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward only"):
        fa.flash_attention_fwd(q, k, k)
    with torch.no_grad():
        out = fa.flash_attention_fwd(q, k, k)
    assert out.grad_fn is None
    assert fa.launch_counts() == {"flash_attention_fwd": 1}


def test_flash_attention_bf16_kernel_runs_hgmma(card):
    """The loaded library's bf16 K9 body issues wgmma (SASS HGMMA) fed by
    TMA (UTMALDG); the FMA body does neither."""
    import shutil
    import subprocess
    from repro_torch.kernels import _build
    so = _build.load()._name
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    ops = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = set()
        elif name is not None:
            ops[name].update(op for op in ("HGMMA", "UTMALDG") if op in line)
    mma = [n for n in ops if "fa_mma_kernel" in n]
    fma = [n for n in ops if "fa_fwd_kernel" in n]
    assert mma and fma
    assert all(ops[n] == {"HGMMA", "UTMALDG"} for n in mma)
    assert not any(ops[n] for n in fma)


@pytest.mark.parametrize("kv_int8", [False, True])
def test_serving_engine_on_card_matches_cpu(card, kv_int8):
    """tiny-lm.reduced() (fp32): the K8 engine on the card emits the CPU
    port's tokens, and launches K8 once a layer and decode step."""
    from repro_torch.launch.serve import draw_requests
    cfg = get_config("tiny-lm").reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0))
    scfg = ServeConfig(max_slots=4, page_size=8, max_len=48, prompt_pad=8,
                       attn="pallas", kv_int8=kv_int8)
    reqs = draw_requests(8, 6, 2, 24, cfg.vocab_size, seed=5)
    cpu, _ = ServeEngine(cfg, scfg, params, seed=2, device="cpu").run(reqs)
    pd.reset_launch_counts()
    on_card = tree.map(lambda t: t.to(card), params)
    res, stats = ServeEngine(cfg, scfg, on_card, seed=2).run(reqs)
    assert res == cpu
    assert stats["free_pages_end"] == scfg.total_pages
    assert sum(pd.launch_counts().values()) == 2 * stats["steps"]


# ---------------------------------------------------------- CUDA graphs --
def _bitwise_runs(a, b):
    """Two (state, history) runs bit for bit (host clocks aside)."""
    (sa, ha), (sb, hb) = a, b
    assert len(ha) == len(hb)
    for ra, rb in zip(ha, hb):
        for k, v in ra.items():
            if k in ("wall_ms", "chunk_ms"):
                continue
            x, y = np.asarray(v), np.asarray(rb[k])
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), (k, ra["round"])
    la, lb = tree.leaves(sa), tree.leaves(sb)
    rows = getattr(getattr(sa, "buf", None), "rows", None)
    for i, (x, y) in enumerate(zip(la, lb)):
        if rows is not None and x is rows:  # the drop row takes the
            # dropped parks in no set order and is never read
            x, y = x[:-1], y[:-1]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), (i, float((x.double() - y.double())
                                                .abs().max()))


@pytest.fixture
def deterministic_cudnn(card):
    """cuDNN's deterministic convolutions for one test: the vmapped conv's
    backward otherwise sums in no set order, so that two runs of the eager
    loop itself differ in the last bits (PERF.md section 6)."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield card
    torch.backends.cudnn.deterministic = was


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_sync_round_replay_matches_eager_loop(deterministic_cudnn, compress):
    """``fedfits.run(driver="scan")`` on the card (the round captured once
    and replayed, partial chunks of 3 over 7 rounds) bitwise its per-round
    loop under deterministic cuDNN, with availability and explore draws
    every round; the kernels' launch counts are the loop's."""
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    cfg = FedConfig(n_clients=6, local_epochs=2, local_lr=0.05, msl=3,
                    pft=2, aggregator="trimmed_mean", avail_prob=0.7,
                    explore_eps=0.3, compress=compress, error_feedback=True)
    fed, _ = build_federation(0, n=600, n_clients=6, batch_size=16)
    runs, counts = [], []
    for drv in ("python", "scan"):
        rp.reset_launch_counts()
        dq.reset_launch_counts()
        runs.append(fedfits.run(model, cfg, fed.data_fn, 7, 1, driver=drv,
                                chunk_rounds=3))
        counts.append({**rp.launch_counts(), **dq.launch_counts()})
    _bitwise_runs(runs[1], runs[0])
    assert counts[1] == counts[0] and max(counts[1].values()) >= 7
    assert len({r["avail"].tobytes() for r in runs[1][1][1:]}) > 1


def test_async_round_replay_matches_eager_loop(deterministic_cudnn):
    model = build(MLP_CONFIG)
    fed, _ = build_federation(0, kind="tabular", n=600, n_clients=24,
                              batch_size=8)
    cfg = FedConfig(n_clients=4, population=24, local_epochs=2,
                    local_lr=0.05, aggregator="trimmed_mean",
                    async_max_retries=2, select_method="pallas")
    late = faults.FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                              base_delay=0.3)
    runs, k7 = [], []
    for drv in ("python", "scan"):
        ps.reset_launch_counts()
        runs.append(async_engine.run_async(model, cfg, fed.data, 6, 2,
                                           batch_size=8, faults=late,
                                           driver=drv, chunk_rounds=4))
        k7.append(ps.launch_counts()["block_topd"])
    _bitwise_runs(runs[1], runs[0])
    assert k7 == [6, 6]


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_decode_step_replay_matches_eager(card, temperature):
    """The serving engine's captured decode step against ``_decode`` run
    eagerly on the same states: the same tokens, K8 once a layer and
    step, replays included."""
    from repro_torch.core.driver import copy_into
    from repro_torch.launch.serve import draw_requests
    from repro_torch.serve import engine as serve_engine

    class Eager(ServeEngine):
        def _step(self, cache, st):
            _, st2, out = self._decode(self.params, cache, st)
            host = serve_engine._to_host(out)
            copy_into(st, st2)
            return host

    cfg = get_config("tiny-lm").reduced()
    params = tree.map(lambda t: t.to(card),
                      build(cfg).init(torch.Generator().manual_seed(0)))
    scfg = ServeConfig(max_slots=4, page_size=8, max_len=48, prompt_pad=8,
                       attn="pallas", temperature=temperature)
    reqs = draw_requests(8, 6, 2, 24, cfg.vocab_size, seed=5)
    eager, _ = Eager(cfg, scfg, params, seed=2).run(reqs)
    pd.reset_launch_counts()
    engine = ServeEngine(cfg, scfg, params, seed=2)
    res, stats = engine.run(reqs)
    assert res == eager
    assert engine._graph is not None
    assert sum(pd.launch_counts().values()) == 2 * stats["steps"]
    again, _ = engine.run(reqs)                   # the same graph, reset
    assert again == res


def _capture(fn):
    """fn() captured as a CUDA graph after one eager warm-up call on the
    capture stream; returns (graph, the eager output, the graph's)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        warm = fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, warm, out


def test_k7_and_k8_counters_hold_across_replays(card):
    """K7's merge counter (kept by device and stream) and K8's item
    counters are made by the warm-up and left at 0 by every launch: 100
    replays on fresh inputs each give the eager kernel's output."""
    gen = torch.Generator(card).manual_seed(0)
    keys = torch.rand(16_384, generator=gen, device=card)
    graph, _, idx = _capture(lambda: ps.topd_pallas(keys, 16))
    q, kp, vp, table, lengths = _paged(card)
    q = q.clone()
    graph8, _, att = _capture(lambda: pd.paged_flash_decode(
        q, kp, vp, table, lengths))
    for i in range(100):
        keys.copy_(ps.draw_gumbel(keys.shape[0], gen))
        q.normal_(generator=gen)
        graph.replay()
        graph8.replay()
        assert torch.equal(idx, ps.topd_pallas(keys, 16)), i
        assert torch.equal(att, pd.paged_flash_decode(q, kp, vp, table,
                                                      lengths)), i
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in ps._COUNTERS.values())
    assert all(int(c.abs().sum()) == 0 for c in pd._COUNTERS.values())


def test_driver_counts_replays_and_registers_generators(card):
    """A body that draws from a generator registered with the graph and
    launches K2: each replay draws the next numbers (those of the eager
    loop, never the same twice) and counts one launch."""
    from repro_torch.core import driver
    gen = torch.Generator(card).manual_seed(7)
    x, m, w = (t[:1].contiguous() for t in _inputs(card, c=16, n=4096))

    def body(st, xs):
        u = torch.rand(8, generator=gen, device=card)
        out = rp.gated_combine(x, m, w, mode="mean")
        return {"n": st["n"] + 1}, {"u": u, "s": out.sum()}

    drv = driver.ScanDriver(body, chunk_steps=4, generators=(gen,))
    rp.reset_launch_counts()
    state = {"n": torch.zeros((), dtype=torch.int32, device=card)}
    final, hist = drv.run(state, lambda t: {}, 9, t0=1)
    assert (drv.captures, drv.replays) == (1, 8)
    assert rp.launch_counts()["gated_combine[mean]"] == 9
    assert int(final["n"]) == 9 and int(state["n"]) == 0
    ref = torch.Generator(card).manual_seed(7)
    draws = [torch.rand(8, generator=ref, device=card).cpu().numpy()
             for _ in range(9)]
    for row, u in zip(hist, draws):
        assert row["u"].tobytes() == u.tobytes()
    assert len({row["u"].tobytes() for row in hist}) == 9
    final, hist = drv.run(state, lambda t: {}, 3, t0=1)   # replays only
    assert drv.captures == 1 and int(final["n"]) == 3
    assert final["n"] is drv._graph.state["n"]     # donated: the buffers
    keep = driver.ScanDriver(body, chunk_steps=4, generators=(gen,),
                             donate=False)
    final, _ = keep.run(state, lambda t: {}, 2, t0=1)
    assert final["n"] is not keep._graph.state["n"] and int(final["n"]) == 2


# ------------------------------------------ K7 past its shared memory ----

@pytest.mark.parametrize("label,m,d,kind", topd_checks.LARGE_CASES)
def test_topd_past_shared_memory_matches_cpu_path(card, label, m, d, kind):
    """Cohorts of d > 16,384: ``topd_pallas`` takes K7's global path (a
    radix select and a bitonic sort over global memory) and returns
    bitwise the CPU path's indices, twice alike, one count a call."""
    g = topd_checks.keys(m, d, d, kind, m + d, card)
    out = topd_checks.global_path(g, d)
    assert torch.equal(topd_checks.global_path(g, d), out)


def test_topd_shapes_that_fit_keep_the_one_launch_path(card):
    """d = 16,384 (the largest whose CTA fits) and the timed shapes of
    earlier slices stay on the one-launch shared-memory path."""
    for m, d in ((100_000, 16_384), (16_384, 16), (100_000, 64),
                 (1_000_000, 64)):
        topd_checks.smem_path(topd_checks.keys(m, d, 4096, "gumbel", m, card),
                              d)


def test_k9_replays_bitwise_its_eager_call(card):
    """K9 captured in a CUDA graph (its TMA maps passed by value) and
    replayed on new contents of the same buffers gives the eager call's
    output on those contents, bit for bit, in both bodies."""
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(card).manual_seed(3)
        q, k, v = (torch.randn(1, h, 128, 128, generator=gen, device=card,
                               dtype=dtype) for h in (24, 8, 8))
        graph, _, out = _capture(lambda: fa.flash_attention_fwd(q, k, v))
        for _ in range(3):
            for t in (q, k, v):
                t.copy_(torch.randn(t.shape, generator=gen, device=card,
                                    dtype=dtype))
            graph.replay()
            assert torch.equal(out, fa.flash_attention_fwd(q, k, v))


# --------------------------------------------- the captured admission ----

def _eager_admission_engine():
    """A ServeEngine whose admissions run ``_admit`` eagerly every time (its
    decode step still captured): the admission's baseline."""
    from repro_torch.core.driver import copy_into
    from repro_torch.serve import engine as serve_engine

    class EagerAdmit(ServeEngine):
        def _admission(self, cache, st, r):
            self._load_request(r)
            st2, out = self._admit_static(cache, st)
            host = serve_engine._to_host(out)
            copy_into(st, st2)
            return host

    return EagerAdmit


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_admission_replay_matches_eager(card, temperature):
    """The admission captured once and replayed for every later request
    (plen, max_new and req_id as device scalars in a static buffer) gives
    the eager admission's run: the same tokens, and the engine's pools
    (but the drop page) and whole SlotState (its counter column too)
    bitwise; the sampling draws
    of both graphs advance the generator as the eager steps do."""
    from repro_torch.launch.serve import draw_requests
    cfg = get_config("tiny-lm").reduced()
    params = tree.map(lambda t: t.to(card),
                      build(cfg).init(torch.Generator().manual_seed(0)))
    scfg = ServeConfig(max_slots=4, page_size=8, max_len=48, prompt_pad=16,
                       attn="pallas", temperature=temperature)
    reqs = draw_requests(10, 12, 1, 24, cfg.vocab_size, seed=6)
    eager = _eager_admission_engine()(cfg, scfg, params, seed=2)
    res_e, stats_e = eager.run(reqs)
    engine = ServeEngine(cfg, scfg, params, seed=2)
    res, stats = engine.run(reqs)
    assert res == res_e and stats["steps"] == stats_e["steps"]
    assert engine._admit_graph is not None and eager._admit_graph is None
    (cache_e, st_e), (cache, st) = eager._static, engine._static
    for f in st._fields:
        if f == "gen":
            assert torch.equal(st.gen.get_state(), st_e.gen.get_state())
        elif f == "tele":
            for k in st.tele:
                assert torch.equal(st.tele[k], st_e.tele[k]), k
        else:
            assert torch.equal(getattr(st, f), getattr(st_e, f)), f
    for b in cache:         # the drop page (the last) takes the inactive
        for k in cache[b]:  # slots' appends in no set order, never read
            assert torch.equal(cache[b][k][:, :-1], cache_e[b][k][:, :-1]), \
                (b, k)
    assert float(st.tele["serve/admitted"]) == len(reqs)
    again, _ = engine.run(reqs)                 # the same graphs, reset
    assert again == res


# ------------------------------------------------- telemetry on the card --

def test_telemetry_on_off_bitwise_on_card(deterministic_cudnn, tmp_path):
    """Sync and async under the default (replayed) driver with telemetry on
    and off: the same run bit for bit but the obs/ keys; the counter
    column's totals the sums of the rows; the artifacts pass the port's
    schema check."""
    from repro_torch.obs import JsonlSink, Telemetry
    from repro_torch.obs.check import check_jsonl, check_trace
    model = build(MLP_CONFIG)
    sync_fed, _ = build_federation(0, kind="tabular", n=600, n_clients=6,
                                   batch_size=8)
    async_fed, _ = build_federation(0, kind="tabular", n=600, n_clients=24,
                                    batch_size=8)
    late = faults.FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                              base_delay=0.3)
    runs = {
        "sync": lambda **kw: fedfits.run(
            model, FedConfig(n_clients=6, local_lr=0.05, avail_prob=0.7,
                             aggregator="trimmed_mean"), sync_fed.data_fn,
            7, 1, chunk_rounds=3, **kw),
        "async": lambda **kw: async_engine.run_async(
            model, FedConfig(n_clients=4, population=24, local_lr=0.05,
                             aggregator="trimmed_mean", async_max_retries=2,
                             select_method="pallas"), async_fed.data, 7, 2,
            batch_size=8, faults=late, chunk_rounds=4, **kw)}
    for engine, run in runs.items():
        jsonl, trace = str(tmp_path / f"{engine}.jsonl"), \
            str(tmp_path / f"{engine}.json")
        tele = Telemetry(sinks=[JsonlSink(jsonl)], trace_path=trace)
        st_on, h_on = run(telemetry=tele)
        tele.finish()
        st_off, h_off = run()
        h_strip = [{k: v for k, v in r.items() if not k.startswith("obs/")}
                   for r in h_on]
        _bitwise_runs((st_off, h_off),
                      (st_on._replace(tele=None), h_strip))
        assert not check_jsonl(jsonl, require_obs=True, engine=engine)
        assert not check_trace(trace, min_phases=5)
        for name in ("wire/bytes_up", "select/team_size"):
            rows = [float(r["obs/" + name]) for r in h_on]
            want = sum(rows) if name.startswith("wire") else rows[-1]
            assert float(st_on.tele[name]) == want, (engine, name)


# ------------------------------------------------------------ the pod path --
POD_SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab_size=128, head_dim=16)


def _pod_leaves():
    """The leaf sizes of tiny-lm at the small config (its 12 leaves)."""
    cfg = get_config("tiny-lm").replace(**POD_SMALL)
    from repro_torch.models import transformer
    params = transformer.init_transformer(torch.Generator(), cfg)
    return [p.numel() for p in tree.leaves(params)]


def test_pod_kernels_match_plain(card):
    """K1-K3 and K6a-c at the pod path's shape, C = 4 clients over the
    small tiny-lm's leaves, against their plain versions."""
    sizes = _pod_leaves()
    n = sum(sizes)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 4, n), np.float32)
                         * 1e-2).to(card)
    m = torch.ones(1, 4, device=card)
    w = torch.full((1, 4), 0.25, device=card)
    for o, r in zip(rp.cosine_gate_partials(x, m),
                    rp.cosine_gate_partials_plain(x, m)):
        _close_rel(o, r)
    for mode in rp.MODES:
        out = rp.gated_combine(x, m, w, mode=mode)
        ref = rp.gated_combine_plain(x, m, w, mode=mode)
        if mode == "median":
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    _close_rel(rp.pairwise_gram(x), rp.pairwise_gram_plain(x))
    layout = codecs.WireLayout(sizes, 128)
    enc = codecs.Codec("int8").encode_flat(x[0], layout)
    q, s = enc.q[None], enc.s[None]
    for o, r in zip(dq.dequant_gate_partials(q, s, layout, m),
                    dq.dequant_gate_partials_plain(q, s, layout, m)):
        _close_rel(o, r)
    torch.testing.assert_close(
        dq.dequant_gated_combine(q, s, layout, m, w, mode="mean"),
        dq.dequant_gated_combine_plain(q, s, layout, m, w, mode="mean"),
        rtol=1e-5, atol=1e-6)
    _close_rel(dq.dequant_pairwise_gram(q, s, layout, m),
               dq.dequant_pairwise_gram_plain(q, s, layout, m))


def test_gram_long_chunks_hold_against_fp64(card):
    """K3 and K6c at 2^26 columns, C = 4 (chunks of ~1.3e5 columns a block
    on a 132-SM card, as on the pod path): the diagonal and the
    off-diagonal entries each within 1e-5 of their own largest fp64
    value."""
    n = 1 << 26
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((1, 4, n), np.float32)
                         * 1e-2).to(card)
    m = torch.ones(1, 4, device=card)
    layout = codecs.WireLayout([n], 128)
    enc = codecs.Codec("int8").encode_flat(x[0], layout)
    q, s = enc.q[None], enc.s[None]
    eye = torch.eye(4, dtype=torch.bool, device=card)
    for out, xs in ((rp.pairwise_gram(x), x),
                    (dq.dequant_pairwise_gram(q, s, layout, m),
                     dq.dequant_masked(q, s, layout, m))):
        exact = torch.bmm(xs.double(), xs.double().transpose(1, 2))
        for sel in (eye, ~eye):
            e = exact[:, sel]
            err = float((out.double()[:, sel] - e).abs().max())
            assert err <= 1e-5 * float(e.abs().max())


@pytest.mark.parametrize("fed_kw", [
    dict(aggregator="fedavg"), dict(aggregator="trimmed_mean"),
    dict(aggregator="krum"), dict(aggregator="fedavg", compress="int8")],
    ids=["fedavg", "trimmed_mean", "krum", "int8"])
def test_pod_step_on_card_matches_cpu(card, fed_kw):
    """Two per-client pod steps on the card (the kernels) and on the CPU
    port (their plain versions) from the same init and batches, SGD:
    the same team, params within 1e-5; each kernel of the path launched
    once a step."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import pod
    from repro_torch.models import transformer
    from repro_torch.optim import optimizers
    cfg = get_config("tiny-lm").replace(**POD_SMALL)
    fed = FedConfig(n_clients=4, **fed_kw)
    tc = TrainConfig(global_batch=8, seq_len=32, lr=1e-2, warmup_steps=1,
                     total_steps=4, optimizer="sgd")
    opt_init, _ = optimizers.make_optimizer(tc)
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg)
    s_cpu = pod.init_pod_state(params, opt_init, 4, fed, torch.Generator())
    to = lambda v: v.to(card) if isinstance(v, torch.Tensor) else v
    s_gpu = tree.map(to, s_cpu)
    s_gpu = s_gpu._replace(fed=s_gpu.fed._replace(
        rng=torch.Generator(card)))
    step = pod.make_train_step(cfg, fed, tc, robust="per_client")
    rng = np.random.default_rng(5)
    rp.reset_launch_counts()
    dq.reset_launch_counts()
    for _ in range(2):
        toks = torch.from_numpy(rng.integers(0, 128, (8, 33)))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        s_gpu, _ = step(s_gpu, tree.map(to, batch))
        s_cpu, _ = step(s_cpu, batch)
        assert torch.equal(s_gpu.fed.team.cpu(), s_cpu.fed.team)
        for a, b in zip(tree.leaves(s_gpu.params), tree.leaves(s_cpu.params)):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5)
    counts = {**rp.launch_counts(), **dq.launch_counts()}
    pass1 = ("dequant_gate_partials" if "compress" in fed_kw
             else "cosine_gate_partials")
    assert counts[pass1] == 2
    if fed_kw["aggregator"] == "krum":
        assert counts["pairwise_gram"] == 2


@pytest.mark.parametrize("kernel", ["pass1", "mean", "trimmed", "median",
                                    "gram"])
def test_kernels_past_2_to_32_elements(card, kernel):
    """K1, K2 (three modes) and K3 on a (1, 4, 2^30 + 4,099) fp32 buffer:
    4.3e9 elements, so rows 2 and 3 start past 2^31 and the last row's
    tail lies past 2^32 (granite's per-client grads at C = 4 are 5.5e9).
    Zeros but the last 4,096 columns of each row:
    the kernels over the whole buffer against their plain versions on
    those columns (the zeros add exact zeros), and K2's other columns 0.
    A row offset kept in 32 bits would read the wrong rows' tails."""
    n, tail = (1 << 30) + 4099, 4096
    if torch.cuda.get_device_properties(card).total_memory < 40e9:
        pytest.skip("needs a card with 40 GB")
    x = torch.zeros(1, 4, n, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    x[..., -tail:] = torch.randn(1, 4, tail, generator=g, device=card)
    assert 2 * n > 1 << 31 and 4 * n - tail > 1 << 32
    small = x[..., -tail:].contiguous()
    m = torch.ones(1, 4, device=card)
    w = torch.tensor([[0.1, 0.2, 0.3, 0.4]], device=card)
    if kernel == "pass1":
        for o, r in zip(rp.cosine_gate_partials(x, m),
                        rp.cosine_gate_partials_plain(small, m)):
            _close_rel(o, r)
    elif kernel == "gram":
        _close_rel(rp.pairwise_gram(x), rp.pairwise_gram_plain(small))
    else:
        out = rp.gated_combine(x, m, w, mode=kernel)
        ref = rp.gated_combine_plain(small, m, w, mode=kernel)
        assert float(out[:, :-tail].abs().max()) == 0.0
        if kernel == "median":
            assert torch.equal(out[:, -tail:], ref)
        else:
            torch.testing.assert_close(out[:, -tail:], ref, rtol=1e-5,
                                       atol=1e-6)
