"""The port's round math against the JAX package on the same inputs:
models and their gradients, fitness, slots, fairness, the selection
policies fed JAX's own draws, the partition, and params interop.

Tolerances: masks, ranks and partitions exact; model outputs, losses and
gradients atol 1e-5 (conv and matmul sum in other orders); fitness and
fairness rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_models import CNN_CONFIG as JCNN, MLP_CONFIG as JMLP
from repro.core import fairness as jfair, fitness as jfit, \
    selection as jsel, slots as jslots
from repro.data import partition as jpart
from repro.models import small as jsmall
from repro_torch import interop, tree
from repro_torch.configs.paper_models import CNN_CONFIG, MLP_CONFIG
from repro_torch.core import fairness, fitness, selection, slots
from repro_torch.data import partition
from repro_torch.models import small
from repro_torch.models.model import build

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("arch", ["cnn", "cnn_reduced", "mlp"])
def test_models_and_grads_match_jax(arch):
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(3)
    if arch == "mlp":
        cfg, jcfg = MLP_CONFIG, JMLP
        jparams = jsmall.init_mlp_clf(key, jcfg)
        x = rng.standard_normal((16, 22)).astype(np.float32)
        jfwd, fwd = jsmall.mlp_clf_fwd, small.mlp_clf_fwd
    else:
        kw = dict(d_model=4, d_ff=16) if arch == "cnn_reduced" else {}
        cfg, jcfg = CNN_CONFIG.replace(**kw), JCNN.replace(**kw)
        jparams = jsmall.init_cnn(key, jcfg)
        x = rng.uniform(0, 1, (8, 28, 28, 1)).astype(np.float32)
        jfwd, fwd = jsmall.cnn_fwd, small.cnn_fwd
    y = rng.integers(0, cfg.vocab_size, x.shape[0]).astype(np.int32)
    params = interop.params_from_numpy(_np(jparams))

    def jloss(p):
        return jsmall.classifier_loss(jfwd(p, jnp.asarray(x)),
                                      jnp.asarray(y))

    (jl, ja), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    np.testing.assert_allclose(fwd(params, _t(x)).numpy(),
                               np.asarray(jax.jit(jfwd)(jparams,
                                                        jnp.asarray(x))),
                               atol=1e-5)
    loss_fn = lambda p: small.classifier_loss(fwd(p, _t(x)), _t(y))[0]
    g = torch.func.grad(loss_fn)(params)
    l, a = small.classifier_loss(fwd(params, _t(x)), _t(y))
    np.testing.assert_allclose(float(l), float(jl), atol=1e-5)
    assert float(a) == float(ja)
    for gl, jgl in zip(tree.leaves(g), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(gl.numpy(), np.asarray(jgl), atol=1e-5)


def test_build_matches_param_layout():
    """init gives the JAX tree's structure, shapes and leaf order."""
    for cfg, jcfg, jinit in [(CNN_CONFIG, JCNN, jsmall.init_cnn),
                             (MLP_CONFIG, JMLP, jsmall.init_mlp_clf)]:
        p = build(cfg).init(torch.Generator().manual_seed(0))
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        shapes = [tuple(l.shape) for l in tree.leaves(p)]
        assert shapes == [l.shape for l in jax.tree_util.tree_leaves(jp)]
        for l in tree.leaves(p):                  # truncated at ±2 sigma
            if l.dim() > 1:
                fan_in = l[..., 0].numel()
                assert float(l.abs().max()) <= 2.0 / np.sqrt(fan_in) + 1e-6
    n = sum(l.numel() for l in tree.leaves(
        build(CNN_CONFIG).init(torch.Generator().manual_seed(0))))
    assert n == 421_642                         # the paper CNN at full width


def test_params_round_trip():
    jp = _np(jsmall.init_cnn(jax.random.PRNGKey(1), JCNN))
    back = interop.params_to_numpy(interop.params_from_numpy(jp))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_fitness_matches_jax():
    rng = np.random.default_rng(0)
    gl, ll = (rng.uniform(0.1, 3, 9).astype(np.float32) for _ in range(2))
    ga, la = (rng.uniform(0, 1, 9).astype(np.float32) for _ in range(2))
    n = rng.integers(10, 300, 9).astype(np.float32)
    avail = (rng.uniform(0, 1, 9) > 0.3).astype(np.float32)
    for exact in (False, True):
        np.testing.assert_allclose(
            fitness.theta(*map(_t, (gl, ga, ll, la)), paper_exact=exact),
            jfit.theta(*map(jnp.asarray, (gl, ga, ll, la)),
                       paper_exact=exact), rtol=RTOL, atol=ATOL)
    th = np.asarray(jfit.theta(*map(jnp.asarray, (gl, ga, ll, la))))
    q = np.asarray(jfit.data_quality(jnp.asarray(n), jnp.asarray(avail)))
    np.testing.assert_allclose(fitness.data_quality(_t(n), _t(avail)), q,
                               rtol=RTOL, atol=ATOL)
    a = jfit.dynamic_alpha(jnp.asarray(q), jnp.asarray(th),
                           jnp.asarray(avail))
    assert float(fitness.dynamic_alpha(_t(q), _t(th), _t(avail))) == float(a)
    s = np.asarray(jfit.score(jnp.asarray(q), jnp.asarray(th), a))
    np.testing.assert_allclose(fitness.score(_t(q), _t(th), float(a)), s,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(fitness.threshold(_t(s), 0.1, _t(avail))),
        float(jfit.threshold(jnp.asarray(s), 0.1, jnp.asarray(avail))),
        rtol=RTOL)
    np.testing.assert_allclose(
        float(fitness.team_theta(_t(th), _t(avail))),
        float(jfit.team_theta(jnp.asarray(th), jnp.asarray(avail))),
        rtol=RTOL)


@pytest.mark.parametrize("adaptive", [False, True])
def test_slot_updates_match_jax(adaptive):
    thetas = [3.0, 2.9, 2.8, 2.7, 2.9, 2.5, 2.4, 2.6, 2.6, 2.0]
    js, ps = jslots.init_slot_state(), slots.init_slot_state()
    for t, th in enumerate(thetas, start=1):
        js, jh = jslots.update(js, jnp.float32(th), jnp.int32(t), 4, 2,
                               adaptive=adaptive)
        ps, ph = slots.update(ps, torch.tensor(th), t, 4, 2,
                              adaptive=adaptive)
        assert bool(ph) == bool(jh), t
        assert int(ps.p) == int(js.p), t
        np.testing.assert_allclose(float(ps.theta_ema), float(js.theta_ema),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(ps.theta_var), float(js.theta_var),
                                   rtol=RTOL, atol=ATOL)


def test_fairness_matches_jax():
    rng = np.random.default_rng(2)
    acc = rng.uniform(0, 1, 11).astype(np.float32)
    avail = (rng.uniform(0, 1, 11) > 0.3).astype(np.float32)
    cum = rng.integers(0, 9, 11).astype(np.float32)
    ref = jfair.round_fairness(jnp.asarray(acc), jnp.asarray(avail),
                               jnp.asarray(cum))
    out = fairness.round_fairness(_t(acc), _t(avail), _t(cum))
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    zero = np.zeros(11, np.float32)
    assert float(fairness.worst_decile(_t(acc), _t(zero))) == 0.0
    assert float(fairness.participation_gini(_t(zero))) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_selection_policies_fed_jax_draws(seed):
    k = 12
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    avail = (rng.uniform(0, 1, k) > 0.25).astype(np.float32)
    losses = rng.uniform(0, 3, k).astype(np.float32)
    n = rng.integers(5, 500, k).astype(np.float32)
    js, ja = jnp.asarray(scores), jnp.asarray(avail)

    for floor_p, eps in [(0.0, 0.0), (0.3, 0.2)]:
        ref = jsel.fedfits_select(js, 0.1, ja, key, floor_prob=floor_p,
                                  explore_eps=eps)
        r1, r2 = jax.random.split(key)
        out = selection.fedfits_select(
            _t(scores), 0.1, _t(avail),
            _t(jax.random.uniform(r1, (k,))), _t(jax.random.uniform(r2, (k,))),
            floor_prob=floor_p, explore_eps=eps)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # empty-team fallback: everything below threshold -> best available
    low = np.where(avail > 0, -1.0, 5.0).astype(np.float32)
    low[int(np.argmax(avail))] = -0.5
    ref = jsel.fedfits_select(jnp.asarray(low), -5.0, ja, key)
    out = selection.fedfits_select(_t(low), -5.0, _t(avail),
                                   torch.ones(k), torch.ones(k))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))

    np.testing.assert_array_equal(selection.fedavg_select(_t(avail)).numpy(),
                                  np.asarray(jsel.fedavg_select(ja)))
    ref = jsel.fedrand_select(ja, 0.5, key)
    out = selection.fedrand_select(_t(avail), 0.5,
                                   _t(jax.random.uniform(key, (k,))))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    ref = jsel.fedpow_select(jnp.asarray(losses), ja, 6, 3, key,
                             n=jnp.asarray(n))
    out = selection.fedpow_select(_t(losses), _t(avail), 6, 3,
                                  _t(jax.random.gumbel(key, (k,))), n=_t(n))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_draws_are_seeded():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    for draw in (selection.draw_fedfits, selection.draw_fedrand,
                 selection.draw_fedpow):
        a, b = draw(16, g1), draw(16, g2)
        for x, y in zip(tree.leaves(a), tree.leaves(b)):
            assert torch.equal(x, y)


def test_partition_matches_jax():
    labels = np.random.default_rng(0).integers(0, 10, 900)
    x = np.random.default_rng(1).standard_normal((900, 3)).astype(np.float32)
    ref = jpart.dirichlet_partition(np.random.default_rng(7), labels, 9, 0.3)
    out = partition.dirichlet_partition(np.random.default_rng(7), labels, 9,
                                        0.3)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    sa, sb = partition.stack_clients(x, labels, out), \
        jpart.stack_clients(x, labels, ref)
    for k in sb:
        np.testing.assert_array_equal(sa[k], sb[k])
