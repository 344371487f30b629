"""K5 (``robust_agg_fwd``), its tree wrappers, the flat wrappers K4a-c and
the two-stage scheme of the port against the JAX package on the same
numpy inputs.  On the CPU the port runs the kernels' plain versions; the
JAX side runs its Pallas kernels in interpret mode, as its own tests do.
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the CUDA kernels
against those plain versions on the card.

Tolerances: K5's median picks entries, so it is exact against the Pallas
kernel (which picks the same rank positions); the trimmed mean and every
sum over clients within atol 1e-6, the sort-based oracles within 1e-5
(another summation order); the Eq.-11 pipelines (a cosine gate, then the
combine) within 1e-5; Krum's distances off the diagonal within 1e-5 of
the largest (sums over N in other orders).  The diagonal of a masked-in
row is exactly 0 in the port by design (ROADMAP queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import aggregation as jaggregation
from repro.kernels import robust_pipeline as jrp
from repro.kernels.robust_agg_ops import (robust_aggregate_tree as
                                          jrobust_tree,
                                          robust_aggregate_tree_ref as
                                          jrobust_tree_ref)
from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregation
from repro_torch.kernels import robust_agg, robust_agg_ops
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.kernels.robust_agg_ref import robust_agg_ref

LEAVES = {"a": (13, 7), "b": (257,)}          # ragged N = 348 over two leaves
AGGREGATORS = ["fedavg", "trimmed_mean", "median", "krum"]


def _tree(c, seed=0, lead=()):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(lead + (c,) + s).astype(np.float32)
            for k, s in LEAVES.items()}


def _mask(c, kind):
    m = np.ones(c, np.float32)
    if kind == "one":
        m[:] = 0.0
        m[c // 2] = 1.0
    elif kind == "empty":
        m[:] = 0.0
    elif kind == "mixed":
        m[::3] = 0.0
    return m


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["full", "one", "empty", "mixed"])
@pytest.mark.parametrize("c", [3, 8, 17, 64])
def test_k5_plain_matches_pallas_and_oracle(c, kind):
    tree, mask = _tree(c, seed=c), _mask(c, kind)
    for mode in ("trimmed", "median"):
        out = robust_agg_ops.robust_aggregate_tree(
            _t(tree), torch.from_numpy(mask), mode=mode, trim_frac=0.2)
        pallas = jrobust_tree(_j(tree), jnp.asarray(mask), mode=mode,
                              trim_frac=0.2, interpret=True)
        ref = robust_agg_ops.robust_aggregate_tree_ref(
            _t(tree), torch.from_numpy(mask), mode=mode, trim_frac=0.2)
        jref = jrobust_tree_ref(_j(tree), jnp.asarray(mask), mode=mode,
                                trim_frac=0.2)
        for k in LEAVES:
            if mode == "median":
                np.testing.assert_array_equal(out[k].numpy(),
                                              np.asarray(pallas[k]))
            else:
                np.testing.assert_allclose(out[k].numpy(),
                                           np.asarray(pallas[k]), atol=1e-6)
            np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                       atol=1e-5)
            np.testing.assert_allclose(ref[k].numpy(), np.asarray(jref[k]),
                                       atol=1e-5)
            if kind == "empty":
                assert not out[k].numpy().any()
            if kind == "one":
                np.testing.assert_array_equal(out[k].numpy(),
                                              tree[k][c // 2])


def test_k5_is_k2_rank_modes_and_ref():
    """On the CPU too, K5 is K2's trimmed / median mode under the team mask,
    and ``robust_agg_ref`` is the sort-based oracle of the same contract."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((9, 700)).astype(np.float32))
    m = torch.from_numpy(_mask(9, "mixed"))
    for mode in ("trimmed", "median"):
        out = robust_agg.robust_agg_fwd(x, m, mode=mode, trim_frac=0.25)
        k2 = rp.gated_combine(x[None], m[None], m[None], mode=mode,
                              trim_frac=0.25)[0]
        assert torch.equal(out, k2)
        torch.testing.assert_close(
            out, robust_agg_ref(x, m, mode=mode, trim_frac=0.25),
            rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        robust_agg.robust_agg_fwd(x, m, mode="mean")


@pytest.mark.parametrize("mode", ["trimmed", "median"])
def test_k5_defends_poison(mode):
    """The reference's poisoned-row test: one row at -1e6 does not move
    the aggregate off the honest ~1."""
    c = 8
    rng = np.random.default_rng(0)
    honest = 1.0 + 0.01 * rng.standard_normal((c, 64)).astype(np.float32)
    honest[0] = -1e6
    out = robust_agg_ops.robust_aggregate_tree(
        {"w": torch.from_numpy(honest)}, torch.ones(c), mode=mode)
    assert bool((out["w"] > 0.9).all())


def test_k5_bf16_leaves():
    """bf16 leaves are cast to fp32 before the kernel and the result back
    to bf16 (the reference's ``test_robust_agg_dtype_bf16_inputs``)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 384)).astype(np.float32)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).bfloat16()
    out = robust_agg_ops.robust_aggregate_tree({"w": tw}, torch.ones(16),
                                               mode="median")
    assert out["w"].dtype == torch.bfloat16
    ref = jrobust_tree({"w": jw}, jnp.ones(16), mode="median",
                       interpret=True)
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(ref["w"].astype(jnp.float32)))


@pytest.mark.parametrize("aggregator", AGGREGATORS)
def test_flat_wrappers_and_two_stage_match_jax(aggregator):
    """K4a-c's API (``fused_aggregate_tree_flat``,
    ``fused_two_stage_tree(_flat)``) and ``two_stage`` / ``two_stage_ref``
    at G = 2 against the JAX flat oracles."""
    c, g = 8, 2
    jcfg = JFedConfig(n_clients=c, aggregator=aggregator, krum_f=1)
    cfg = FedConfig(n_clients=c, aggregator=aggregator, krum_f=1)
    slot = _tree(c, seed=11, lead=(g,))
    slot["a"][0, 2] *= -4.0             # one client pointing the other way
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 2.0, (g, c)).astype(np.float32)
    m = np.stack([_mask(c, "full"), _mask(c, "mixed")])

    single = {k: v[0] for k, v in slot.items()}
    out = rp.fused_aggregate_tree_flat(_t(single), torch.from_numpy(w[0]),
                                       torch.from_numpy(m[0]), cfg)
    ref = jrp.fused_aggregate_tree_flat(_j(single), jnp.asarray(w[0]),
                                        jnp.asarray(m[0]), jcfg)
    lead = rp.fused_aggregate_tree(_t(single), torch.from_numpy(w[0]),
                                   torch.from_numpy(m[0]), cfg)
    for k in LEAVES:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5)
        assert torch.equal(out[k], lead[k])       # the same kernels

    args = (_t(slot), torch.from_numpy(w), torch.from_numpy(m), cfg)
    jargs = (_j(slot), jnp.asarray(w), jnp.asarray(m), jcfg)
    jflat = jrp.fused_two_stage_tree_flat(*jargs)
    outs = {"fused_two_stage_tree": rp.fused_two_stage_tree(*args),
            "fused_two_stage_tree_flat": rp.fused_two_stage_tree_flat(*args),
            "two_stage": aggregation.two_stage(*args),
            "two_stage_ref": aggregation.two_stage_ref(*args)}
    refs = {"fused_two_stage_tree": jrp.fused_two_stage_tree(*jargs),
            "two_stage_ref": jaggregation.two_stage_ref(*jargs)}
    for name, o in outs.items():
        for k in LEAVES:
            np.testing.assert_allclose(o[k].numpy(), np.asarray(jflat[k]),
                                       atol=1e-5, err_msg=name)
            if name in refs:
                np.testing.assert_allclose(o[k].numpy(),
                                           np.asarray(refs[name][k]),
                                           atol=1e-5, err_msg=name)


def test_pairwise_sq_dists_blocked_off_diagonal():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4096)).astype(np.float32)
    mask = np.stack([_mask(9, "full"), _mask(9, "mixed")])
    out = rp.pairwise_sq_dists_blocked(torch.from_numpy(x),
                                       torch.from_numpy(mask)).numpy()
    ref = np.asarray(jrp.pairwise_sq_dists_blocked(
        jnp.asarray(x), jnp.asarray(mask), blk=4096, interpret=True))
    off = ~np.eye(9, dtype=bool)[None].repeat(2, 0)
    np.testing.assert_allclose(out[off], ref[off],
                               atol=1e-5 * np.abs(ref[ref < 1e29]).max())
    # d_ii: 0 for a masked-in row, the 1e30 push for a masked-out one
    np.testing.assert_array_equal(np.diagonal(out, axis1=1, axis2=2),
                                  np.float32(1e30) * (1.0 - mask))


def test_pairwise_gram_plain_c96():
    """The Gram's plain version past the old C <= 64 limit, against numpy
    in float64."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 96, 10_000)).astype(np.float32)
    out = rp.pairwise_gram_plain(torch.from_numpy(x)).numpy()
    ref = np.einsum("gin,gjn->gij", x.astype(np.float64), x.astype(np.float64))
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())
