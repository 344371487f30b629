"""Every attack of the port (``repro_torch.core.attacks``) against the JAX
package's on the same numpy inputs: K = 10 clients, three malicious, two
leaves (the port takes them as one (K, N) buffer in JAX's flatten order).

Tolerances, each with its reason:
  * elementwise attacks (flips, scaling, noise, triggers): atol 1e-6;
    XLA may fuse the multiply-adds;
  * the honest statistics sum over K rows in other orders: 1e-6 relative
    (1e-5 where a square root or ndtri follows);
  * ALIE's z through ``torch.special.ndtri``: within 1e-6 of JAX's;
  * the bisections compare sums over N that the two packages add in
    other orders, so near convergence the last steps may decide the other
    way: gamma (min-max / min-sum) within gamma_0 * 2^-20 and the blend w
    (gate_aware) within 2^-16 of JAX's, the crafted rows within what that
    moves them; and against a float64 rerun, every decision more than 1e-4
    relative from its budget must agree, so gamma lies within the steps
    that remain after the first decision closer than that;
  * CrossRoundGateAware's blend exactly, over three observe cycles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtri

from repro.configs.base import FedConfig as JFedConfig
from repro.core import attacks as jattacks
from repro_torch.configs.base import FedConfig
from repro_torch.core import attacks

K, N_MAL = 10, 3
SHAPES = {"a": (3, 5), "b": (17,)}


def _updates(seed=0):
    rng = np.random.default_rng(seed)
    drift = rng.standard_normal(sum(int(np.prod(s)) for s in SHAPES.values()))
    flat = (0.3 * drift[None] + rng.standard_normal((K, drift.size))) \
        .astype(np.float32)
    tree, o = {}, 0
    for k, s in SHAPES.items():
        n = int(np.prod(s))
        tree[k] = flat[:, o:o + n].reshape((K,) + s)
        o += n
    mal = np.zeros(K, np.float32)
    mal[:N_MAL] = 1.0
    return tree, flat, mal


def _jflat(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(K, -1)
                           for k in sorted(tree)], 1)


def _jtree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------- data ----

@pytest.mark.parametrize("mode", ["shift", "target"])
def test_label_flip(mode):
    rng = np.random.default_rng(1)
    y = rng.integers(0, 7, (K, 6)).astype(np.int32)
    _, _, mal = _updates()
    ref = jattacks.label_flip(jnp.asarray(y), 7, jnp.asarray(mal), mode=mode)
    out = attacks.label_flip(_t(y), 7, _t(mal), mode=mode)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layout", ["images", "tabular"])
def test_backdoor_trigger_and_stamp(layout):
    """NHWC image batches get the corner patch, (K, B, D) tabular ones the
    feature prefix, exactly as in JAX."""
    rng = np.random.default_rng(2)
    shape = (K, 4, 8, 8, 1) if layout == "images" else (K, 4, 22)
    x = rng.uniform(0, 0.5, shape).astype(np.float32)
    y = rng.integers(1, 5, (K, 4)).astype(np.int32)
    _, _, mal = _updates()
    jx, jy = jattacks.backdoor_trigger(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(mal), target=0, patch=3)
    px, py = attacks.backdoor_trigger(_t(x), _t(y), _t(mal), target=0,
                                      patch=3)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(py.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        attacks.stamp_trigger(_t(x[0])).numpy(),
        np.asarray(jattacks.stamp_trigger(jnp.asarray(x[0]))))
    assert not np.array_equal(px.numpy()[0], x[0])      # stamped
    np.testing.assert_array_equal(px.numpy()[N_MAL:], x[N_MAL:])


@pytest.mark.parametrize("layout", ["images", "tabular"])
def test_feature_noise_fed_jax_noise(layout):
    rng = np.random.default_rng(3)
    shape = (K, 4, 8, 8, 1) if layout == "images" else (K, 4, 22)
    x = rng.standard_normal(shape).astype(np.float32)
    _, _, mal = _updates()
    key = jax.random.PRNGKey(7)
    ref = jattacks.feature_noise(jnp.asarray(x), jnp.asarray(mal), 0.5, key)
    noise = jax.random.normal(key, shape, jnp.float32)
    out = attacks.feature_noise(_t(x), _t(mal), 0.5, _t(noise))
    _close(out, ref)


# --------------------------------------------------------------- model ----

def test_static_update_attacks():
    tree, flat, mal = _updates()
    jt, jm = _jtree(tree), jnp.asarray(mal)
    _close(attacks.sign_flip(_t(flat), _t(mal), scale=10.0),
           _jflat(jattacks.sign_flip(jt, jm, scale=10.0)))
    _close(attacks.scale_attack(_t(flat), _t(mal), 5.0),
           _jflat(jattacks.scale_attack(jt, jm, 5.0)))
    key = jax.random.PRNGKey(4)
    ref = _jflat(jattacks.gaussian_update(jt, jm, 2.0, key))
    keys = jax.random.split(key, len(tree))      # the JAX leaves' own noise
    noise = np.concatenate([np.asarray(jax.random.normal(
        k, (K,) + SHAPES[name], jnp.float32)).reshape(K, -1)
        for k, name in zip(keys, sorted(tree))], 1)
    out = attacks.gaussian_update(_t(flat), _t(mal), 2.0, _t(noise))
    _close(out, ref)
    np.testing.assert_array_equal(out.numpy()[N_MAL:], flat[N_MAL:])


@pytest.mark.parametrize("z", [4.0, None])
def test_alie(z):
    tree, flat, mal = _updates()
    ref = _jflat(jattacks.alie(_jtree(tree), jnp.asarray(mal), z=z))
    out = attacks.alie(_t(flat), _t(mal), z=z).numpy()
    _close(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out[N_MAL:], flat[N_MAL:])
    if z is None:
        # z = ndtri(phi) with phi = (n - m - s) / (n - m): both fp32 ndtri
        n, m = np.float32(K), np.float32(N_MAL)
        phi = np.float32(np.clip((n - m - (np.floor(n / 2 + 1) - m))
                                 / (n - m), 0.5, 1 - 1e-6))
        zt = float(torch.special.ndtri(torch.tensor(phi)))
        zj = float(jax.scipy.special.ndtri(jnp.float32(phi)))
        assert abs(zt - zj) <= 1e-6 and abs(zt - ndtri(float(phi))) <= 1e-6


def _f64_gamma(flat, mal, dev, mode, n_iters=25, gamma0=10.0):
    """The min-max / min-sum bisection in float64, and the first step whose
    decision lies within 1e-4 relative of its budget."""
    x = flat.astype(np.float64)
    h = 1.0 - mal.astype(np.float64)
    mu = (x * h[:, None]).sum(0) / h.sum()
    sd = np.sqrt((h[:, None] * (x - mu) ** 2).sum(0) / h.sum())
    p = {"std": -sd, "unit": -mu / np.linalg.norm(mu),
         "sign": -np.sign(mu)}[dev]
    d = ((x[:, None] - x[None]) ** 2).sum(-1)
    if mode == "max":
        budget = (d * np.outer(h, h)).max()
    else:
        budget = np.where(h > 0, (d * h[None]).sum(1), -np.inf).max()
    diff = mu[None] - x
    a, b, c = (diff * diff).sum(1), diff @ p, p @ p
    g, step, best, first_close = gamma0, gamma0 / 2, 0.0, n_iters
    for i in range(n_iters):
        dist = a + 2 * g * b + g * g * c
        val = np.where(h > 0, dist, -np.inf).max() if mode == "max" \
            else (dist * h).sum()
        if abs(val - budget) / budget < 1e-4:
            first_close = min(first_close, i)
        ok = val <= budget
        best = max(best, g) if ok else best
        g, step = (g + step if ok else g - step), step / 2
    return best, first_close


@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("dev", ["std", "unit", "sign"])
def test_min_max_min_sum(mode, dev):
    tree, flat, mal = _updates()
    fn = {"max": "min_max", "sum": "min_sum"}[mode]
    ref = _jflat(getattr(jattacks, fn)(_jtree(tree), jnp.asarray(mal),
                                       dev=dev))
    out = getattr(attacks, fn)(_t(flat), _t(mal), dev=dev).numpy()
    gamma, mu, p = (v.numpy() for v in attacks._distance_gamma(
        _t(flat), _t(mal), dev=dev, mode=mode, n_iters=25, gamma_init=10.0))
    g64, first_close = _f64_gamma(flat, mal, dev, mode)
    # JAX's gamma from its crafted row, by least squares along p
    gj = float((ref[0].astype(np.float64) - mu) @ p / (p @ p))
    tol = 10.0 * 2.0 ** -20
    assert abs(float(gamma) - gj) <= tol and abs(float(gamma) - g64) <= tol
    # the decisions before the first close one agree: the steps left
    # after it (10 / 2^(i+1) each) bound the difference
    assert first_close >= 10
    assert abs(float(gamma) - g64) <= 10.0 * 2.0 ** -first_close + 1e-5
    _close(out, ref, atol=tol * float(np.abs(p).max()) + 1e-5)
    np.testing.assert_array_equal(out[N_MAL:], flat[N_MAL:])


def _blend_from(crafted, v, ref):
    """w with crafted = (1 - w) v + w ref (least squares, float64)."""
    c, v, r = (np.asarray(a, np.float64) for a in (crafted, v, ref))
    return float((c - v) @ (r - v) / ((r - v) @ (r - v)))


@pytest.mark.parametrize("thresh", [-0.5, 0.8])
@pytest.mark.parametrize("aggregator", ["trimmed_mean", "krum", "median",
                                        "fedavg"])
def test_gate_aware(aggregator, thresh):
    """At the default gate (-0.5) the poison corner already clears it (w =
    0); at 0.8 the bisection runs."""
    tree, flat, mal = _updates()
    jcfg = JFedConfig(n_clients=K, aggregator=aggregator, trim_frac=0.3,
                      cosine_outlier_thresh=thresh)
    cfg = FedConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(FedConfig)})
    ref = _jflat(jattacks.gate_aware(_jtree(tree), jnp.asarray(mal), jcfg))
    out = attacks.gate_aware(_t(flat), _t(mal), cfg).numpy()
    np.testing.assert_array_equal(out[N_MAL:], flat[N_MAL:])
    v, r, lo, hi, trims = attacks._gate_aware_targets(_t(flat), _t(mal), cfg)
    jv, jr, jlo, jhi, _ = jattacks._gate_aware_targets(
        jnp.asarray(flat), jnp.asarray(mal), jcfg)
    for a, b in ((v, jv), (r, jr)):
        _close(a.numpy(), b, atol=1e-5)
    if trims:
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    w = float(attacks._gate_blend(v, r, thresh + 0.1, 20))
    assert (w == 0.0) == (thresh < 0)
    tol = 2.0 ** -16
    if trims:
        # the blend stays inside the window, so the clip is the identity
        assert abs(w - _blend_from(ref[0], v.numpy(), r.numpy())) <= tol
        _close(out, ref, atol=tol * float((v - r).abs().max()) + 1e-5)
    else:
        # the gate sees direction only: the rows agree up to w's step
        # along the rescaled direction
        scale = float(np.linalg.norm(out[0]))
        _close(out, ref, atol=tol * scale + 1e-4 * scale)


def test_cross_round_gate_aware_three_cycles():
    """The blend is exact over three observe cycles (caught, evaded,
    caught); the crafted rows within 1e-5."""
    tree, flat, mal = _updates()
    jcfg = JFedConfig(n_clients=K, aggregator="trimmed_mean", trim_frac=0.3)
    cfg = FedConfig(n_clients=K, aggregator="trimmed_mean", trim_frac=0.3)
    ja, pa = jattacks.CrossRoundGateAware(jcfg), \
        attacks.CrossRoundGateAware(cfg)
    jc, pc = ja.init(K), pa.init(K)
    gated = [np.eye(K, dtype=np.float32)[1], np.zeros(K, np.float32),
             np.eye(K, dtype=np.float32)[0] + np.eye(K, dtype=np.float32)[5]]
    for bad in gated:
        jout, jb = ja(_jtree(tree), jnp.asarray(mal), None, jc)
        pout, pb = pa(_t(flat), _t(mal), None, pc)
        assert np.float32(pb) == np.float32(jb)
        _close(pout.numpy(), _jflat(jout), atol=1e-5)
        jc, pc = ja.observe(jb, jnp.asarray(bad)), pa.observe(pb, _t(bad))
        np.testing.assert_array_equal(pc[1].numpy(), np.asarray(jc[1]))
    idx = torch.tensor([3, 0, 5])
    g = pa.gather(pc, idx)
    assert g[0] is pc[0]
    np.testing.assert_array_equal(g[1].numpy(), gated[-1][[3, 0, 5]])
