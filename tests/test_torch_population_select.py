"""The port's Gumbel-top-d selection (repro_torch/kernels/population_select.py)
against the JAX package's, on the same numpy keys.

The JAX side runs as its own tests run it: ``topd_pallas`` with K7 in
interpret mode, ``topd_segmented`` and ``topd_argsort`` through XLA.  On the
CPU the port's K7 wrapper runs its plain version ``block_topd_plain``; the
CUDA kernel is held against that on the card (tests/test_torch_cuda.py and
``chip_smoke.py``).

Everything here is exact: indices are compared in order, including keys
with many duplicates (ties go to the lower index on every route) and keys
tied at +-0.0, where each route follows the JAX package's route of the same
name (``lax.top_k`` puts +0.0 above -0.0 on the segmented and pallas routes,
``jnp.argsort`` ties them), and K7's stage-1 candidates bitwise, including
the blocks whose finite keys run out and the merge over their repeated
tails.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro.core import selection as jselection
from repro.kernels import population_select as jps
from repro_torch.core import selection
from repro_torch.kernels import population_select as ps

M_VALUES = (1, 63, 64, 4095, 4096, 4097, 10007)


def _keys(m, dup, seed=0):
    rng = np.random.default_rng(seed + m)
    if dup:                                   # ~30 distinct values: ties
        return rng.integers(0, 30, m).astype(np.float32)
    return rng.standard_normal(m).astype(np.float32)


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("blk", [64, 4096])
@pytest.mark.parametrize("m", M_VALUES)
def test_topd_matches_jax_every_method(m, blk, dup):
    g = _keys(m, dup)
    for d in (1, 16, 64):
        ref = np.asarray(jps.topd_argsort(jnp.asarray(g), d))
        for method in ps.METHODS:
            jout = np.asarray(jps.topd(jnp.asarray(g), d, method=method,
                                       blk=blk))
            out = ps.topd(torch.from_numpy(g), d, method=method, blk=blk)
            assert out.dtype == torch.int32
            np.testing.assert_array_equal(out.numpy(), jout,
                                          err_msg=f"{method} d={d}")
            np.testing.assert_array_equal(out.numpy(), ref,
                                          err_msg=f"{method} d={d}")


def _jax_candidates(g, d, blk):
    """The JAX package's K7 stage 1 (``topd_pallas`` before its merge), in
    interpret mode."""
    blk = max(blk, d)
    gp, mp = jps._pad_neg_inf(jnp.asarray(g), blk)
    nb = mp // blk
    v, gi = pl.pallas_call(
        functools.partial(jps._block_topd_body, d=d, blk=blk),
        grid=(nb,),
        in_specs=[pl.BlockSpec((1, blk), lambda i: (0, i))],
        out_specs=[pl.BlockSpec((1, d), lambda i: (i, 0)),
                   pl.BlockSpec((1, d), lambda i: (i, 0))],
        out_shape=[jax.ShapeDtypeStruct((nb, d), jnp.float32),
                   jax.ShapeDtypeStruct((nb, d), jnp.int32)],
        interpret=True)(gp.reshape(1, mp))
    return np.asarray(v), np.asarray(gi)


@pytest.mark.parametrize("m,d,blk,dup", [
    (10007, 64, 64, False),    # ragged last block: 23 finite keys < d
    (4097, 16, 4096, False),   # padded last block: 1 finite key
    (300, 64, 64, True),       # duplicates in every block; last short
    (200, 5, 64, False),
])
def test_block_topd_plain_matches_pallas_candidates(m, d, blk, dup):
    g = _keys(m, dup, seed=1)
    jv, jgi = _jax_candidates(g, d, blk)
    gp, _ = ps._pad_neg_inf(torch.from_numpy(g), max(blk, d))
    v, gi = ps.block_topd(gp, d, max(blk, d))
    assert v.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(v.numpy().view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), jgi)


def _signed_zeros(m, seed, finite=None):
    """Keys from {1.0, -0.0, +0.0, -1.0}, so rare 1.0s that every top-d
    reaches into the zeros tied at +-0.0; with ``finite``, only that many of
    them, at random positions, the rest -inf."""
    rng = np.random.default_rng(seed)
    g = rng.choice(np.array([1.0, -0.0, 0.0, -1.0], np.float32), m,
                   p=[0.002, 0.4, 0.4, 0.198])
    if finite is not None:
        keep = np.zeros(m, bool)
        keep[rng.choice(m, finite, replace=False)] = True
        g[~keep] = -np.inf
    return g


def test_signed_zero_minimal_case():
    """[-0.0, +0.0, -1.0], d = 2: ``lax.top_k`` puts +0.0 above -0.0 on the
    segmented and pallas routes; ``jnp.argsort`` ties the zeros."""
    g = np.array([-0.0, 0.0, -1.0], np.float32)
    want = {"argsort": [0, 1], "segmented": [1, 0], "pallas": [1, 0]}
    for method in ps.METHODS:
        jout = np.asarray(jps.topd(jnp.asarray(g), 2, method=method, blk=64))
        out = ps.topd(torch.from_numpy(g), 2, method=method, blk=64)
        np.testing.assert_array_equal(jout, want[method], err_msg=method)
        np.testing.assert_array_equal(out.numpy(), want[method],
                                      err_msg=method)


@pytest.mark.parametrize("method", ps.METHODS)
@pytest.mark.parametrize("m,d,blk", [(200, 16, 64), (300, 64, 64),
                                     (4097, 16, 4096), (10007, 64, 4096)])
def test_signed_zero_keys_match_jax_route(method, m, d, blk):
    """Keys tied at +-0.0: each route of the port gives the JAX package's
    route of the same name (pallas with K7 in interpret mode)."""
    g = _signed_zeros(m, seed=m + d)
    jout = np.asarray(jps.topd(jnp.asarray(g), d, method=method, blk=blk))
    out = ps.topd(torch.from_numpy(g), d, method=method, blk=blk)
    np.testing.assert_array_equal(out.numpy(), jout)


@pytest.mark.parametrize("m,d", [(300, 16), (300, 300), (40, 64)])
def test_argsort_route_matches_jnp_argsort(m, d):
    """The argsort route, and every route when d >= M, is ``jnp.argsort``'s
    order: -0.0 tied with +0.0, the lower index first."""
    g = _signed_zeros(m, seed=m + d)
    ref = np.asarray(jnp.argsort(-jnp.asarray(g)))[:d]
    np.testing.assert_array_equal(
        ps.topd_argsort(torch.from_numpy(g), d).numpy(), ref)
    for method in ps.METHODS if d >= m else ("argsort",):
        out = ps.topd(torch.from_numpy(g), d, method=method)
        np.testing.assert_array_equal(out.numpy(), ref, err_msg=method)


@pytest.mark.parametrize("m,d,blk", [(300, 40, 64), (100, 16, 64),
                                     (1000, 64, 256)])
def test_signed_zero_candidates_match_pallas(m, d, blk):
    """K7's stage 1 on +-0.0 ties (argmax's rule: the zeros equal, the first
    index wins), bitwise against the JAX package's kernel."""
    g = _signed_zeros(m, seed=m)
    jv, jgi = _jax_candidates(g, d, blk)
    gp, _ = ps._pad_neg_inf(torch.from_numpy(g), blk)
    v, gi = ps.block_topd(gp, d, blk)
    np.testing.assert_array_equal(v.numpy().view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(gi.numpy(), jgi)


@pytest.mark.parametrize("m,d,blk", [(300, 40, 64), (100, 16, 64),
                                     (1000, 64, 256)])
def test_exhausted_tails_merge_matches_jax_pallas(m, d, blk):
    """Blocks with fewer than d keys above -inf end in repeated (-inf,
    first index) candidates, and the merge takes them in candidate order:
    the pallas route repeats those indices as the JAX package's
    ``topd_pallas`` does (interpret mode), on +-0.0 ties too."""
    g = _signed_zeros(m, seed=m + 1, finite=d // 2)  # tails reach the top-d
    jout = np.asarray(jps.topd_pallas(jnp.asarray(g), d, blk=blk))
    out = ps.topd(torch.from_numpy(g), d, method="pallas", blk=blk).numpy()
    np.testing.assert_array_equal(out, jout)
    assert len(set(out.tolist())) < d               # repeated indices
    np.testing.assert_array_equal(
        ps.topd_pallas_plain(torch.from_numpy(g), d, blk).numpy(), jout)


def test_order_key_is_lax_top_k_order():
    """``_order_key`` orders floats as ``lax.top_k`` does: -inf < ... < -0.0
    < +0.0 < ... < +inf, each bit pattern its own key."""
    x = np.array([-np.inf, -3.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 2.0,
                  np.inf], np.float32)
    k = ps._order_key(torch.from_numpy(x)).numpy()
    assert k.dtype == np.int32 and (np.diff(k.astype(np.int64)) > 0).all()
    _, j = jax.lax.top_k(jnp.asarray(x[::-1].copy()), len(x))
    np.testing.assert_array_equal(np.argsort(-k.astype(np.int64)),
                                  len(x) - 1 - np.asarray(j))


def test_exhausted_block_repeats_its_first_index():
    """Once a block's finite keys are used up, every further candidate is
    the block's first index with value -inf (``jnp.argmax`` of an all -inf
    block is position 0)."""
    g = torch.from_numpy(_keys(4096 + 10, False))
    gp, _ = ps._pad_neg_inf(g, 4096)
    v, gi = ps.block_topd(gp, 16, 4096)
    assert torch.isfinite(v[1, :10]).all()
    assert torch.equal(gi[1, 10:], torch.full((6,), 4096, dtype=torch.int32))
    assert bool((v[1, 10:] == -float("inf")).all())


def test_ties_go_to_the_lower_index():
    g = np.tile(np.array([1, 3, 3, 0, 3, 2, 3, 1], np.float32), 3)
    for method in ps.METHODS:
        out = ps.topd(torch.from_numpy(g), 5, method=method, blk=64)
        np.testing.assert_array_equal(out.numpy(), [1, 2, 4, 6, 9])


@pytest.mark.parametrize("method", ps.METHODS)
def test_degenerate_cohort_is_argsort(method):
    g = _keys(40, False)
    out = ps.topd(torch.from_numpy(g), 64, method=method)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jps.topd(jnp.asarray(g), 64, method=method)))
    assert sorted(out.tolist()) == list(range(40))


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        ps.topd(torch.zeros(8), 2, method="quickselect")


def test_gumbel_topd_proportional_sampling():
    """Efraimidis-Spirakis: a 10x-weighted client appears far more often in
    a 2-of-20 cohort than a 1x one (the port of the JAX package's test)."""
    w = torch.ones(20)
    w[3] = 10.0
    logw = torch.log(w)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(20)
    for _ in range(300):
        idx = ps.gumbel_topd(logw, 2, ps.draw_gumbel(20, gen)).numpy()
        assert len(set(idx.tolist())) == 2          # without replacement
        counts[idx] += 1
    # P(include) = 10/29 + (19/29)(10/28) ~ 0.58 vs ~0.075 for the rest
    others = np.delete(counts, 3)
    assert counts[3] > 140
    assert others.mean() < 40
    assert counts[3] > 4 * others.mean()


@pytest.mark.parametrize("method", ps.METHODS)
def test_population_cohort_fed_jax_gumbel(method):
    pri = jax.random.uniform(jax.random.PRNGKey(2), (500,), minval=0.01)
    for s in range(5):
        key = jax.random.PRNGKey(7 + s)
        ref = np.asarray(jselection.population_cohort(pri, 12, key,
                                                      method=method, blk=64))
        gumbel = np.array(jax.random.gumbel(key, (500,), jnp.float32))
        out = selection.population_cohort(
            torch.from_numpy(np.array(pri)), 12, torch.from_numpy(gumbel),
            method=method, blk=64)
        np.testing.assert_array_equal(out.numpy(), ref)


def test_draw_gumbel_is_standard_gumbel():
    g = ps.draw_gumbel(200_000, torch.Generator().manual_seed(1))
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert abs(float(g.mean()) - 0.5772) < 0.01       # Euler-Mascheroni
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03
