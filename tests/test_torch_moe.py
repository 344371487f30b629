"""The port's MoE FFN (``repro_torch/models/moe.py``) against the JAX
package's ``repro/models/moe.py`` on the same numpy inputs and JAX's own
init, on the CPU.

  * the routing (each token's top-k experts, which routed pairs keep a
    capacity slot and the slot each takes) bitwise JAX's: with no drops
    (``reduced()``'s capacity E), with drops (capacity_factor 1.25 and a
    router that sends most tokens to one expert) and with router logits
    tied on purpose (two experts' router columns equal, so every token's
    probabilities tie; ``lax.top_k`` puts the lower expert first);
  * the layer's output within 1e-5 of its largest value (the expert
    matmuls and the combine sum in other orders), its aux loss within
    1e-6;
  * ``_capacity`` equal to JAX's at every token count;
  * the grads through the layer (the pod trainer's path) within 1e-5 of
    their largest against ``jax.grad``.
JAX's routing is read by the same ``jnp`` lines as ``moe_fwd`` runs
(``_jax_routing``), since ``moe_fwd`` returns only its output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs.registry import ARCHS
from repro_torch.models import moe

REL = 1e-5
AUX_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny layers: one intra-op thread keeps the suite's parallel workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name="granite-moe-1b-a400m", **kw):
    return (JARCHS[name].reduced().replace(**kw),
            ARCHS[name].reduced().replace(**kw))


def _params(jc, seed=0, hot=None, tie=None):
    """JAX's init (numpy); ``hot``: expert whose router column is raised so
    most tokens pick it; ``tie``: (a, b), expert b's router column set to
    expert a's."""
    p = jax.tree_util.tree_map(
        np.array, jmoe.init_moe(jax.random.PRNGKey(seed), jc))
    if hot is not None:
        p["router"][:, hot] += 0.5
    if tie is not None:
        a, b = tie
        p["router"][:, b] = p["router"][:, a]
    return p


def _x(jc, b, s, seed=1, shift=0.0):
    """Normal inputs; ``shift`` moves their mean, so that a raised router
    column (``_params(hot=...)``) wins for every token."""
    return (np.random.default_rng(seed).standard_normal(
        (b, s, jc.d_model)) + shift).astype(np.float32)


def _jax_routing(p, x, cfg):
    """(top_e, keep, dest) of ``repro/models/moe.py:moe_fwd``, by its own
    lines."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xf = jnp.asarray(x).reshape(N, d)
    logits = (xf @ jnp.asarray(p["router"])).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, K)
    C = jmoe._capacity(N, cfg)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    same = jnp.cumsum(jnp.ones_like(sorted_e))
    start = jnp.searchsorted(sorted_e, jnp.arange(E))
    rank = (same - 1) - start[sorted_e]
    keep = rank < C
    dest = jnp.where(keep, sorted_e * C + rank, E * C)
    flat_tok = jnp.repeat(jnp.arange(N), K)
    return (np.asarray(top_e), np.asarray(keep), np.asarray(dest),
            np.asarray(flat_tok[order]))


def _port_routing(p, x, cfg):
    tp = interop.params_from_numpy(p)
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    _, _, top_e, _ = moe.route(tp, xf, cfg)
    order, tok, keep, dest = moe.dispatch(top_e, xf.shape[0], cfg)
    return top_e.numpy(), keep.numpy(), dest.numpy(), tok.numpy()


def _routing_equal(port, ref):
    for name, a, b in zip(("top_e", "keep", "dest", "tok"), port, ref):
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)


def _layer_close(p, x, jc, tc):
    jy, jaux = jmoe.moe_fwd(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), jc)
    ty, taux = moe.moe_fwd(interop.params_from_numpy(p), torch.from_numpy(x),
                           tc)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=REL * np.abs(jy).max())
    assert abs(float(taux) - float(jaux)) <= AUX_ATOL


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_routing_and_output_without_drops(name):
    jc, tc = _cfgs(name)
    p, x = _params(jc), _x(jc, 2, 24)
    port, ref = _port_routing(p, x, tc), _jax_routing(p, x, jc)
    _routing_equal(port, ref)
    assert port[1].all()                  # capacity E: nothing is dropped
    _layer_close(p, x, jc, tc)


@pytest.mark.parametrize("seed", [0, 3])
def test_routing_and_output_with_drops(seed):
    """capacity_factor 1.25 and a router biased to expert 1: every token
    picks it, it overflows and its pairs past the capacity go to the drop
    slot."""
    jc, tc = _cfgs(capacity_factor=1.25)
    p, x = _params(jc, seed, hot=1), _x(jc, 2, 40, seed + 1, shift=0.5)
    port, ref = _port_routing(p, x, tc), _jax_routing(p, x, jc)
    _routing_equal(port, ref)
    keep = port[1]
    assert 0 < (~keep).sum() < keep.size       # some dropped, not all
    assert (port[2][~keep] == tc.n_experts * moe._capacity(80, tc)).all()
    _layer_close(p, x, jc, tc)


@pytest.mark.parametrize("tie", [(0, 1), (2, 3), (0, 3)])
def test_routing_with_tied_logits(tie):
    """Two experts' router columns equal: every token's probabilities tie
    between them, and both packages list the lower expert first."""
    jc, tc = _cfgs(capacity_factor=1.25)
    p, x = _params(jc, 5, tie=tie), _x(jc, 2, 32, 6)
    port, ref = _port_routing(p, x, tc), _jax_routing(p, x, jc)
    top_e = port[0]
    a, b = tie
    both = (top_e == a).any(1) & (top_e == b).any(1)
    assert both.any()
    pos = lambda e: np.argmax(top_e == e, axis=1)
    assert (pos(a)[both] < pos(b)[both]).all()
    _routing_equal(port, ref)
    _layer_close(p, x, jc, tc)


def test_capacity_matches_jax():
    for cf in (1.0, 1.25, 4.0):
        for top_k, e in ((2, 4), (8, 32), (4, 16)):
            jc, tc = _cfgs(capacity_factor=cf, top_k=top_k, n_experts=e)
            for n in (1, 7, 16, 100, 4096, 12345):
                assert moe._capacity(n, tc) == jmoe._capacity(n, jc)


def test_grads_match_jax():
    """At capacity_factor 1.0 (this draw drops pairs), the router's softmax
    unsaturated."""
    jc, tc = _cfgs(capacity_factor=1.0)
    p, x = _params(jc, 7), _x(jc, 2, 20, 8)
    assert not _port_routing(p, x, tc)[1].all()
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(pp):
        y, aux = jmoe.moe_fwd(pp, jnp.asarray(x), jc)
        return jnp.sum(y * w) + aux

    jg = jax.grad(jloss)(jax.tree_util.tree_map(jnp.asarray, p))
    tp = {k: v.requires_grad_(True)
          for k, v in interop.params_from_numpy(p).items()}
    y, aux = moe.moe_fwd(tp, torch.from_numpy(x), tc)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    for k in p:
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), ref, rtol=0,
                                   atol=REL * np.abs(ref).max(), err_msg=k)
