"""The port's robust-aggregation kernels (repro_torch/kernels/) against the
JAX package's Pallas kernels, run in interpret mode on the same numpy
inputs.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held against those plain versions on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``).

Tolerances: the median picks one or two entries, so it is compared
bitwise; sum-based outputs (cosine partials, means, trimmed means, Gram
distances) at rtol 1e-5 / atol 1e-6, because the two packages sum in
different orders.  Ranks, gate masks and Krum winners are exact.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import robust_agg as jrobust_agg
from repro.kernels import robust_pipeline as jrp
from repro_torch import tree
from repro_torch.comm import codecs
from repro_torch.comm.kernels import comm_codecs
from repro_torch.kernels import _build, robust_agg, robust_pipeline as rp

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(c, n) for c in (1, 2, 5, 16) for n in (1000, 3001)]
# pass 1 also at the edges of its register buckets (16, 32, 64) and past them
PASS1_SHAPES = SHAPES + [(c, n) for c in (17, 32, 33, 48, 64, 65)
                         for n in (1000, 3001)]


def _inputs(c, n, g=1, seed=0):
    rng = np.random.default_rng(seed + 97 * c + n)
    x = rng.standard_normal((g, c, n)).astype(np.float32)
    mask = np.ones((g, c), np.float32)
    if c > 2:
        mask[:, 1] = 0.0                     # a masked-out client
    w = rng.uniform(0.1, 1.0, (g, c)).astype(np.float32) * mask
    w /= w.sum(axis=1, keepdims=True)
    return x, mask, w


def _jax_kw(c, n):
    return dict(blk=jrp.auto_blk(c, (n,), backend="cpu"), interpret=True)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_stable_ranks_bitwise_with_ties():
    rng = np.random.default_rng(1)
    xm = rng.integers(0, 4, (7, 300)).astype(np.float32)   # many ties
    xm[2] = 1e30                                           # masked row
    ref = np.asarray(jrobust_agg.stable_ranks(jnp.asarray(xm), 7))
    np.testing.assert_array_equal(robust_agg.stable_ranks(_t(xm)).numpy(),
                                  ref)


@pytest.mark.parametrize("c,n", PASS1_SHAPES)
def test_cosine_gate_partials_matches_pallas(c, n):
    x, mask, _ = _inputs(c, n)
    if c >= 4:
        x[:, 3] = x[:, 2]                    # a tie in every column
    ref = jrp.cosine_gate_partials_leafwise(
        [jnp.asarray(x)], jnp.asarray(mask), leaf_scale=jnp.ones((1,)),
        **_jax_kw(c, n))
    out = rp.cosine_gate_partials(_t(x), _t(mask))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["mean", "trimmed", "median"])
@pytest.mark.parametrize("c,n", SHAPES)
def test_gated_combine_matches_pallas(c, n, mode):
    x, mask, w = _inputs(c, n)
    weights = w if mode == "mean" else mask
    (ref,) = jrp.gated_combine_leafwise(
        [jnp.asarray(x)], jnp.asarray(mask), jnp.asarray(weights),
        mode=mode, trim_frac=0.2, out_dtypes=[jnp.float32], **_jax_kw(c, n))
    out = rp.gated_combine(_t(x), _t(mask), _t(weights), mode=mode,
                           trim_frac=0.2).numpy()
    if mode == "median":
        np.testing.assert_array_equal(out, np.asarray(ref))
    else:
        np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("c,n", SHAPES)
def test_pairwise_sq_dists_matches_pallas(c, n):
    x, mask, _ = _inputs(c, n, g=2)
    ref = np.asarray(jrp.pairwise_sq_dists_leafwise(
        [jnp.asarray(x)], jnp.asarray(mask), leaf_scale=jnp.ones((1,)),
        **_jax_kw(c, n)))
    out = rp.pairwise_sq_dists(_t(x), _t(mask)).numpy()
    off = ~np.eye(c, dtype=bool)[None].repeat(2, 0)
    np.testing.assert_allclose(out[off], ref[off], rtol=RTOL, atol=ATOL)
    # the diagonal is exactly 0 here (norms are the Gram's diagonal), and
    # rounding-level on the TPU side, where the norms are summed apart
    diag = np.diagonal(out, axis1=1, axis2=2)
    np.testing.assert_array_equal(diag,
                                  np.where(mask > 0, 0.0, np.float32(1e30)))


@pytest.mark.parametrize("c,n", [(5, 1000), (16, 3001)])
def test_resolve_gate_exact(c, n):
    x, mask, _ = _inputs(c, n)
    x[0, 0] *= -1.0                          # one client points away
    dots, sqn, refsq = rp.cosine_gate_partials(_t(x), _t(mask))
    for thresh in (-0.5, 0.0, 0.3):
        ref = jrp._resolve_gate(jnp.asarray(dots.numpy()),
                                jnp.asarray(sqn.numpy()),
                                jnp.asarray(refsq.numpy()),
                                jnp.asarray(mask), thresh)
        out = rp._resolve_gate(dots, sqn, refsq, _t(mask), thresh)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    empty = np.zeros_like(mask)
    np.testing.assert_array_equal(
        rp._resolve_gate(dots, sqn, refsq, _t(empty), -0.5).numpy(), empty)


@pytest.mark.parametrize("c", [1, 2, 5, 16])
@pytest.mark.parametrize("case", ["partial", "empty", "lone"])
def test_krum_weights_exact(c, case):
    x, mask, _ = _inputs(c, 1000, g=2)
    if case == "empty":
        mask[:] = 0.0
    elif case == "lone":
        mask[:] = 0.0
        mask[:, c // 2] = 1.0
    d = rp.pairwise_sq_dists(_t(x), _t(mask))
    for f in (0, 1):
        ref = jrp._krum_weights(jnp.asarray(d.numpy()), jnp.asarray(mask),
                                f, 1)
        out = rp._krum_weights(d, _t(mask), f, 1)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["mean", "trimmed", "median"])
def test_empty_and_lone_cohorts(mode):
    """G=3 cohorts: full, empty (zero row) and one member (its row)."""
    x, _, _ = _inputs(5, 1000, g=3)
    mask = np.ones((3, 5), np.float32)
    mask[1] = 0.0
    mask[2] = 0.0
    mask[2, 3] = 1.0
    w = mask / np.maximum(mask.sum(1, keepdims=True), 1.0)
    (ref,) = jrp.gated_combine_leafwise(
        [jnp.asarray(x)], jnp.asarray(mask), jnp.asarray(w), mode=mode,
        out_dtypes=[jnp.float32], **_jax_kw(5, 1000))
    out = rp.gated_combine(_t(x), _t(mask), _t(w), mode=mode).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert np.all(out[1] == 0.0)
    np.testing.assert_allclose(out[2], x[2, 3], rtol=RTOL, atol=ATOL)


def test_wrappers_count_only_kernel_launches():
    """On a CPU tensor the plain version runs and no launch is counted."""
    rp.reset_launch_counts()
    x, mask, w = _inputs(5, 1000)
    rp.fused_pipeline(_t(x), _t(w), _t(mask), aggregator="krum")
    assert set(rp.launch_counts().values()) == {0}


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError):
        rp.cosine_gate_partials(x, torch.ones(1, 2, device="meta"))


@pytest.mark.parametrize("g,c,n", [(1, 96, 65_573), (1, 16, 421_642),
                                   (2, 64, 65_573), (1, 80, 421_642),
                                   (3, 130, 20_011), (1, 5, 1_000),
                                   (1, 16, 31)])
def test_gram_split_covers_n_and_fills_the_card(g, c, n):
    """K3 / K6c's column chunks: a multiple of the stage depth, covering
    N exactly (the last chunk non-empty), and at the main path's shapes
    (async Krum past 64 rows, the sync path at C = 16) at least two waves
    of blocks on the H100's 132 SMs."""
    nsplit, chunk = rp.gram_split(g, c, n, 132)
    side, depth = rp.gram_tile(c)
    assert chunk % depth == 0
    assert (nsplit - 1) * chunk < n <= nsplit * chunk
    nt = -(-c // side)
    blocks = g * nsplit * nt * (nt + 1) // 2
    if n >= 65_573:
        assert blocks >= 2 * 132
    assert rp.gram_split(g, c, n, 132) == (nsplit, chunk)


def test_gram_tiles_follow_c():
    assert rp.gram_tile(16) == (16, 64)
    assert rp.gram_tile(17) == (32, 32)
    assert rp.gram_tile(96) == (32, 32)


@pytest.mark.parametrize("n,vec", [(421_644, 4), (421_642, 2), (421_641, 1),
                                   (421_643, 1), (8, 4)])
@pytest.mark.parametrize("c,path,bucket", [
    (1, "registers", 16), (16, "registers", 16), (17, "registers", 32),
    (32, "registers", 32), (48, "registers", 64), (64, "registers", 64),
    (65, "tile", 0), (96, "tile", 0), (130, "tile", 0)])
def test_combine_plan_follows_c_and_n(c, path, bucket, n, vec):
    """The combine's vector width is the widest of 4, 2, 1 dividing N (so
    every row of the (C, N) matrix starts aligned to it); the mean streams
    at that width for any C; trimmed and median rank in registers over the
    smallest bucket of 16, 32, 64 holding C (2 columns a thread at most in
    the 16 bucket, 1 past it) and past 64 rows from the shared tile."""
    assert rp.combine_plan(c, n, "mean") == ("stream", vec, 0)
    rank_vec = {"registers": min(vec, 2) if bucket == 16 else 1,
                "tile": 1}[path]
    for mode in ("trimmed", "median"):
        assert rp.combine_plan(c, n, mode) == (path, rank_vec, bucket)
        assert n % rank_vec == 0


@pytest.mark.parametrize("c", [1, 16, 64, 65, 130, 450, 451])
def test_combine_smem_follows_the_tile(c):
    """Only the tile path has shared memory, the (C, COMBINE_THREADS) tile
    plus the mask; the check raises past the card's limit."""
    for mode in rp.MODES:
        want = 4 * (c * rp.COMBINE_THREADS + c) if c > 64 \
            and mode != "mean" else 0
        assert rp.combine_smem_bytes(c, 1000, mode) == want
        if want > rp.SMEM_LIMIT:
            with pytest.raises(ValueError):
                rp.check_combine_smem(c, 1000, mode)
        else:
            rp.check_combine_smem(c, 1000, mode)


@pytest.mark.parametrize("c,n,plan", [
    (16, 421_642, ("registers", 16, 2, 824)),    # the sync path
    (48, 421_642, ("registers", 64, 1, 1648)),   # the async path, C + B
    (10, 512, ("registers", 16, 2, 1)),          # poisoning_defense
    (96, 65_573, ("tile", 0, 1, 513)),           # past 64 rows
    (16, 421_641, ("registers", 16, 1, 1648)),
    (1, 1_001, ("registers", 16, 1, 4)),
    (17, 1_000, ("registers", 32, 1, 4)),
    (64, 1_000, ("registers", 64, 1, 4)),
    (65, 1_000, ("tile", 0, 1, 8))])
def test_pass1_plan_follows_c_and_n(monkeypatch, c, n, plan):
    """Pass 1's plan: registers over the combine's buckets for C <= 64 (2
    columns a thread in the 16 bucket when N is even, vec * PASS1_THREADS
    columns a block), the shared tile past 64 rows (PASS1_TILE_COLS
    columns a block), one row of partials a block.  The dense
    (K1 / K4a) and the int8 (K6a) wrappers launch with that plan: their
    launches are recorded here in place of the CUDA library, on CPU
    tensors that are never read."""
    assert rp.pass1_plan(c, n) == plan
    path, bucket, vec, nblk = plan
    cols = vec * rp.PASS1_THREADS if bucket else rp.PASS1_TILE_COLS
    assert n % vec == 0 and (nblk - 1) * cols < n <= nblk * cols
    calls = []
    stub = types.SimpleNamespace(rp_pass1="rp_pass1", cc_pass1="cc_pass1")
    monkeypatch.setattr(rp, "_dispatch", lambda x: True)
    monkeypatch.setattr(rp, "_launch", lambda fn, *a: calls.append((fn, a)))
    monkeypatch.setattr(_build, "load", lambda: stub)
    mask = torch.ones(1, c)
    x = torch.empty(1, c, n)
    layout = codecs.WireLayout([n], 128)
    q = torch.empty(1, c, n, dtype=torch.int8)
    s = torch.empty(1, c, layout.n_scales)
    try:
        for out in (rp.cosine_gate_partials(x, mask),
                    rp.cosine_gate_partials_flat(x, mask),
                    comm_codecs.dequant_gate_partials(q, s, layout, mask)):
            assert [tuple(o.shape) for o in out] == [(1, c), (1, c), (1, 1)]
    finally:
        rp.reset_launch_counts()
        comm_codecs.reset_launch_counts()
    assert [fn for fn, _ in calls] == ["rp_pass1", "rp_pass1", "cc_pass1"]
    for fn, args in calls:
        assert args[-1] == nblk
        assert args[-4 if fn == "rp_pass1" else -7:][:3] == (1, c, n)


@pytest.mark.parametrize("c", [1, 16, 17, 48, 64, 65, 130, 449, 450])
def test_pass1_smem_follows_the_plan(c):
    """A pass-1 block's shared memory: the (C, cols) tile and the median
    row, plus the mask on the tile path; the check raises past the card's
    limit (450 rows)."""
    for n in (1000, 1001):
        _, bucket, vec, _ = rp.pass1_plan(c, n)
        cols = vec * rp.PASS1_THREADS if bucket else rp.PASS1_TILE_COLS
        want = 4 * (c * cols + cols + (0 if bucket else c))
        assert rp.pass1_smem_bytes(c, n) == want
        if want > rp.SMEM_LIMIT:
            with pytest.raises(ValueError):
                rp.check_pass1_smem(c, n)
        else:
            rp.check_pass1_smem(c, n)
    assert (rp.pass1_smem_bytes(c, 1000) > rp.SMEM_LIMIT) == (c >= 450)


def test_register_rank_rule_is_the_stable_rank():
    """The register network's rule, (xm_j <= xm_i) for j < i and
    (xm_j < xm_i) for j > i, gives ``stable_ranks`` exactly, with ties,
    masked rows at 1e30, infinities and a NaN."""
    rng = np.random.default_rng(3)
    xm = rng.integers(0, 4, (11, 200)).astype(np.float32)
    xm[2] = 1e30
    xm[4, :50] = np.inf
    xm[5, :30] = -np.inf
    xm[6, 7] = np.nan
    c = xm.shape[0]
    rule = np.zeros(xm.shape, np.int64)
    for i in range(c):
        for j in range(c):
            if j != i:
                rule[i] += xm[j] <= xm[i] if j < i else xm[j] < xm[i]
    np.testing.assert_array_equal(robust_agg.stable_ranks(_t(xm)).numpy(),
                                  rule)


@pytest.mark.parametrize("b", [16, 32, 64])
def test_padded_rank_rule_is_the_stable_rank(b):
    """Pass 1's register network ranks a bucket of B rows without a row
    predicate: rows C .. B-1 hold +inf, which adds to no real row's rank
    ((+inf < x_i) is never true), so the unpredicated rule over B rows
    gives rows i < C ``stable_ranks`` of the C real rows exactly, with
    ties, masked rows at 1e30, infinities and a NaN."""
    rng = np.random.default_rng(b)
    c = b - 5
    xm = rng.integers(0, 4, (c, 200)).astype(np.float32)
    xm[2] = 1e30
    xm[4, :50] = np.inf
    xm[5, :30] = -np.inf
    xm[6, 7] = np.nan
    pad = np.concatenate([xm, np.full((b - c, 200), np.inf, np.float32)])
    rule = np.zeros(xm.shape, np.int64)
    for i in range(c):
        for j in range(b):
            if j != i:
                rule[i] += pad[j] <= pad[i] if j < i else pad[j] < pad[i]
    np.testing.assert_array_equal(robust_agg.stable_ranks(_t(xm)).numpy(),
                                  rule)


# --------------------------------------------------------------------- #
# a tree's leaves side by side (the segment table)                      #
# --------------------------------------------------------------------- #

LEAF_WIDTHS = [5, 13, 1, 20, 7]


@pytest.mark.parametrize("c", [6, 16])
def test_leaves_side_by_side_are_bitwise_their_concatenation(c):
    """The plain versions over leaves side by side give the concatenated
    matrix's results bit for bit, with steps of 4 and 9 columns that start
    inside leaves and span several, and at the default step."""
    x, mask, w = (_t(a) for a in _inputs(c, sum(LEAF_WIDTHS), g=2))
    leaves = [l.contiguous()
              for l in torch.split(x, LEAF_WIDTHS, dim=-1)]
    m = _t(mask)
    for chunk in (4, 9, rp.PLAIN_CHUNK):
        for o, r in zip(rp.cosine_gate_partials_plain(leaves, m, chunk=chunk),
                        rp.cosine_gate_partials_plain(x, m, chunk=chunk)):
            assert torch.equal(o, r), chunk
        for mode in rp.MODES:
            assert torch.equal(
                rp.gated_combine_plain(leaves, m, w, mode=mode, chunk=chunk),
                rp.gated_combine_plain(x, m, w, mode=mode, chunk=chunk))
        assert torch.equal(rp.pairwise_gram_plain(leaves, chunk=chunk),
                           rp.pairwise_gram_plain(x, chunk=chunk))
    assert rp.dims(leaves) == (2, c, sum(LEAF_WIDTHS))


@pytest.mark.parametrize("agg", ["fedavg", "trimmed_mean", "median", "krum"])
def test_tree_aggregate_is_bitwise_the_concatenated_matrix(agg):
    """``fused_aggregate_tree`` and ``fused_two_stage_tree`` stream a mixed
    tree's leaves in place, bitwise the pipeline on their concatenation."""
    from repro_torch.configs.base import FedConfig
    c = 8
    x, mask, w = (_t(a) for a in _inputs(c, 512 + 301 + 5 + 256, g=2))
    cfg = FedConfig(n_clients=c, aggregator=agg)
    upd = {"w": x[0, :, :512].reshape(c, 64, 8).contiguous(),
           "r": x[0, :, 512:813].contiguous(),
           "b": x[0, :, 813:818].contiguous(),
           "h": x[0, :, 818:].contiguous()}
    cat = torch.cat([l.reshape(c, -1) for l in tree.leaves(upd)], 1)
    whole = rp.fused_pipeline(cat[None], w[:1], mask[:1],
                              **rp._pipeline_args(cfg))[0]
    like = {k: v[0] for k, v in upd.items()}
    for got, ref in zip(tree.leaves(rp.fused_aggregate_tree(
            upd, w[0], mask[0], cfg)), tree.leaves(tree.row_views(whole,
                                                                   like))):
        assert torch.equal(got, ref)
    slots = {k: torch.stack([v, v.flip(0)]) for k, v in upd.items()}
    xs = torch.stack([cat, cat.flip(0)])
    ref = rp._cross_slot(rp.fused_pipeline(xs, w, mask,
                                           **rp._pipeline_args(cfg)), mask)
    for got, r in zip(tree.leaves(rp.fused_two_stage_tree(
            slots, w, mask, cfg)), tree.leaves(tree.row_views(ref, like))):
        assert torch.equal(got, r)


def test_segment_table_offsets_and_limit():
    leaves = [torch.zeros(1, 3, n) for n in LEAF_WIDTHS]
    t = rp._Table(leaves)
    assert list(t.off) == [0, 5, 18, 19, 39, 46]
    assert list(t.ptrs) == [l.data_ptr() for l in leaves]
    assert t.args[2] == len(leaves)
    with pytest.raises(ValueError, match="at most"):
        rp._check_cuda([torch.zeros(1, 3, 2)] * (rp.MAX_SEGS + 1))
