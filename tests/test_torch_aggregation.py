"""The port's aggregation (repro_torch/core/aggregation.py and the fused
pipeline on the CPU) against the JAX package on the same numpy inputs:
the guard, the reference aggregators, the fused Eq.-11 pipeline for all
four aggregators, and the empty-cohort / lone-Krum-survivor cases of
tests/test_empty_mask.py.

Tolerances: masks, rejections and the median are exact; sum-based
outputs rtol 1e-5 / atol 1e-6 (the packages sum in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import aggregation as jagg
from repro.kernels.robust_pipeline import fused_aggregate_tree as jfused
from repro_torch import tree
from repro_torch.configs.base import FedConfig
from repro_torch.core import aggregation as agg
from repro_torch.kernels.robust_pipeline import fused_aggregate_tree

AGGS = ["fedavg", "median", "trimmed_mean", "krum"]
RTOL, ATOL = 1e-5, 1e-6


def _np_tree(c, seed=0):
    rng = np.random.default_rng(seed + c)
    return {"w": rng.standard_normal((c, 13, 7)).astype(np.float32),
            "b": rng.standard_normal((c, 301)).astype(np.float32)}


def _j(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _t(t):
    return tree.map(lambda a: torch.from_numpy(np.array(a)), t)


def _close(out, ref, exact=False):
    for k in ref:
        o, r = np.asarray(out[k], np.float32), np.asarray(ref[k], np.float32)
        if exact:
            np.testing.assert_array_equal(o, r, err_msg=k)
        else:
            np.testing.assert_allclose(o, r, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _mask_w(c, zero=(2,)):
    mask = np.ones(c, np.float32)
    mask[list(zero)] = 0.0
    w = np.random.default_rng(c).uniform(0.1, 1.0, c).astype(np.float32)
    return mask, w


@pytest.mark.parametrize("norm_mult", [1e4, 0.0])
def test_sanitize_updates_matches_jax(norm_mult):
    c = 7
    t = _np_tree(c)
    t["w"][1, 3, 2] = np.nan                  # non-finite row
    t["b"][4] *= 1e6                          # absurd-norm row
    t["b"][5, 0] = np.inf                     # non-finite, masked out
    mask, _ = _mask_w(c, zero=(5,))
    jc, jm, jr = jax.jit(lambda t, m: jagg.sanitize_updates(
        t, m, norm_mult=norm_mult))(_j(t), jnp.asarray(mask))
    pc, pm, pr = agg.sanitize_updates(_t(t), torch.from_numpy(mask),
                                      norm_mult=norm_mult)
    _close(pc, jc, exact=True)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("c", [1, 2, 5, 16])
def test_reference_aggregators_match_jax(c):
    t = _np_tree(c)
    mask, w = _mask_w(c, zero=(1,) if c > 2 else ())
    jt, pt = _j(t), _t(t)
    jm, pm = jnp.asarray(mask), torch.from_numpy(mask)
    jref = jax.jit(lambda t, w, m: (
        jagg.weighted_mean(t, w, m), jagg.median(t, m),
        jagg.trimmed_mean(t, m, 0.2), jagg.krum(t, m, 1),
        jagg.cosine_to_ref(t, jagg.median(t, m))))(jt, jnp.asarray(w), jm)
    _close(agg.weighted_mean(pt, torch.from_numpy(w), pm), jref[0])
    _close(agg.median(pt, pm), jref[1], exact=True)
    _close(agg.trimmed_mean(pt, pm, 0.2), jref[2])
    _close(agg.krum(pt, pm, 1), jref[3])
    np.testing.assert_allclose(agg.cosine_to_ref(pt, agg.median(pt, pm)),
                               jref[4], rtol=RTOL, atol=ATOL)
    scores = np.random.default_rng(3).uniform(0, 1, c).astype(np.float32)
    trust = np.full(c, 0.5, np.float32)
    np.testing.assert_allclose(
        agg.update_trust(torch.from_numpy(trust), torch.from_numpy(scores),
                         pm, 0.9),
        jagg.update_trust(jnp.asarray(trust), jnp.asarray(scores), jm, 0.9),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("aggregator", AGGS)
@pytest.mark.parametrize("c", [5, 16])
def test_fused_and_reference_match_jax(aggregator, c):
    t = _np_tree(c)
    mask, w = _mask_w(c)
    t["b"][0] *= -20.0                        # a client the gate excises
    jcfg = JFedConfig(n_clients=c, aggregator=aggregator)
    cfg = FedConfig(n_clients=c, aggregator=aggregator)
    ref = jfused(_j(t), jnp.asarray(w), jnp.asarray(mask), jcfg)
    out = fused_aggregate_tree(_t(t), torch.from_numpy(w),
                               torch.from_numpy(mask), cfg)
    _close(out, ref, exact=aggregator == "median")
    out_ref = agg.aggregate(_t(t), torch.from_numpy(w),
                            torch.from_numpy(mask),
                            FedConfig(aggregator=aggregator, fused_agg=False))
    _close(out_ref, jax.jit(lambda t, w, m: jagg.aggregate_ref(
        t, w, m, jcfg))(_j(t), jnp.asarray(w), jnp.asarray(mask)))


@pytest.mark.parametrize("aggregator", AGGS)
@pytest.mark.parametrize("case", ["empty", "lone"])
def test_empty_and_lone_cohorts(aggregator, case):
    """An empty cohort gives a zero update on every path; a lone survivor
    passes through unchanged (tests/test_empty_mask.py)."""
    k = 8
    t = _np_tree(k)
    mask = np.zeros(k, np.float32)
    if case == "lone":
        mask[3] = 1.0
    w = np.ones(k, np.float32)
    jcfg = JFedConfig(n_clients=k, aggregator=aggregator)
    ref = jax.jit(lambda t, w, m: jagg.aggregate_ref(t, w, m, jcfg))(
        _j(t), jnp.asarray(w), jnp.asarray(mask))
    for fused in (True, False):
        cfg = FedConfig(n_clients=k, aggregator=aggregator, fused_agg=fused)
        out = agg.aggregate(_t(t), torch.from_numpy(w),
                            torch.from_numpy(mask), cfg)
        _close(out, ref)
        for key in t:
            want = t[key][3] if case == "lone" else np.zeros_like(t[key][0])
            np.testing.assert_allclose(out[key].numpy(), want, atol=1e-6)
