"""``ModelConfig.remat``: each layer unit of ``transformer.forward`` under
``torch.utils.checkpoint`` (non-reentrant, no RNG state saved), the
counterpart of the reference's ``jax.checkpoint(unit_fwd)``.

  * the grads of ``loss_fn`` with ``remat=True`` are bitwise those with
    ``remat=False`` for each block kind (attn, moe, hybrid, the xLSTM
    pair, xattn), on plain tensors;
  * so is a pod step's result on a state placed over a 1 x 2 gloo mesh
    (FSDP x TP, two spawned processes: the recomputed units gather their
    weights again);
  * the pod step with ``remat=True`` holds against the JAX package's (its
    own ``remat=True``) within ``tests/test_torch_pod.py``'s tolerances,
    ``robust=None`` and per_client fedavg;
  * the forward without grad runs no checkpoint.
"""
import jax
import numpy as np
import pytest
import torch

import test_torch_pod as tpod
import torch_pod_tp_cases as tp
from repro_torch import tree
from repro_torch.models import transformer

KINDS = sorted(tp.KINDS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(cfg, batch):
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg)
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, _ = transformer.loss_fn(params, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("kind", KINDS)
def test_remat_grads_bitwise_plain(kind):
    batch = tp.batches(tp.KINDS[kind])[0]
    l1, g1 = _grads(tp.KINDS[kind].replace(remat=True), batch)
    l0, g0 = _grads(tp.KINDS[kind].replace(remat=False), batch)
    assert torch.equal(l1, l0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


def test_remat_recomputes_each_unit_once_under_grad(monkeypatch):
    calls = []
    real = transformer.checkpoint

    def counted(fn, *args, **kw):
        calls.append(kw)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    cfg = tp.KINDS["attn"].replace(remat=True)
    batch = tp.batches(cfg)[0]
    _grads(cfg, batch)
    _, n_units = transformer.layer_cycle(cfg)
    assert len(calls) == n_units
    assert all(kw == {"use_reentrant": False, "preserve_rng_state": False}
               for kw in calls)
    calls.clear()
    params = transformer.init_transformer(torch.Generator().manual_seed(0),
                                          cfg)
    with torch.no_grad():
        transformer.loss_fn(params, cfg, batch)
    assert calls == []


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    return tp.spawn((1, 2), [("remat", k) for k in KINDS],
                    str(tmp_path_factory.mktemp("remat")))


@pytest.mark.parametrize("kind", KINDS)
def test_remat_placed_step_bitwise(placed, kind):
    for r, got in placed.items():
        res = got["remat", kind]
        for a, b in zip(tree.leaves(res[True]), tree.leaves(res[False])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("robust,fed_kw", [
    (None, {}), ("per_client", dict(aggregator="fedavg"))],
    ids=["weighted", "fedavg"])
def test_remat_pod_step_matches_jax(monkeypatch, robust, fed_kw):
    monkeypatch.setattr(tpod, "JCFG", tpod.JCFG.replace(remat=True))
    monkeypatch.setattr(tpod, "CFG", tpod.CFG.replace(remat=True))
    jp = jax.tree_util.tree_map(
        np.asarray, tpod.jtransformer.init_transformer(tpod.KEY, tpod.JCFG))
    tpod._check(tpod._both(jp, fed_kw, robust, steps=1))
