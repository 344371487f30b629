"""The port's pod trainer (``core/pod.py``) over the new block kinds against
the JAX package's ``make_train_step``: one step of
``granite-moe-1b-a400m.reduced()`` (MoE layers, whose aux loss enters the
weighted loss) and of ``hymba-1.5b.reduced()`` (attention | mamba hybrid
blocks), from JAX's init and the same batch (C 4, B 8, S 32), on the CPU.

With ``optimizer="sgd"`` SGD's momentum after one step is the clipped
aggregate itself: the aggregated grads are held within 1e-4 of their
largest (per-client backward passes through the MoE dispatch and the
chunked scan, fp32, summed in other orders), under ``robust=None`` (one
weighted backward) and ``robust='per_client'`` with fedavg and
trimmed_mean (K1 -> K2's plain versions here, JAX's Pallas kernels in
interpret mode); the loss, the team and the grad norm agree too.  A step
whose batch has one client's rows swapped for another's must miss the
aggregate by more than that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import ARCHS as JARCHS
from repro.core import pod as jpod
from repro.data import synthetic as jsynthetic
from repro.models import transformer as jtransformer
from repro.optim import optimizers as jopt
from repro_torch import interop, tree
from repro_torch.configs.base import FedConfig, TrainConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.core import pod
from repro_torch.optim import optimizers

C, B, S = 4, 8, 32
REL = 1e-4
KEY = jax.random.PRNGKey(0)
SGD = dict(global_batch=B, seq_len=S, lr=1e-2, warmup_steps=1,
           total_steps=4, optimizer="sgd")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small models: one intra-op thread keeps the suite's parallel workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["granite-moe-1b-a400m",
                                        "hymba-1.5b"])
def model(request):
    jc = JARCHS[request.param].reduced()
    tc = ARCHS[request.param].reduced()
    jp = jax.tree_util.tree_map(np.asarray,
                                jtransformer.init_transformer(KEY, jc))
    toks = np.asarray(jsynthetic.make_lm_tokens(
        jax.random.PRNGKey(1), B, S + 1, jc.vocab_size, n_latent=2))
    return jc, tc, jp, {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _jax_step(jc, jp, batch, fed_kw, robust):
    jfed, jtc = JFedConfig(n_clients=C, **fed_kw), JTrainConfig(**SGD)
    j_init, _ = jopt.make_optimizer(jtc)
    js = jpod.init_pod_state(jax.tree_util.tree_map(jnp.asarray, jp),
                             j_init, C, jfed, KEY)
    step = jax.jit(jpod.make_train_step(jc, jfed, jtc, robust=robust))
    return step(js, {k: jnp.asarray(v) for k, v in batch.items()})


def _port_step(tc, jp, batch, fed_kw, robust):
    fed, ttc = FedConfig(n_clients=C, **fed_kw), TrainConfig(**SGD)
    opt_init, _ = optimizers.make_optimizer(ttc)
    st = pod.init_pod_state(interop.params_from_numpy(jp), opt_init, C, fed,
                            torch.Generator().manual_seed(0))
    step = pod.make_train_step(tc, fed, ttc, robust=robust)
    return step(st, {k: torch.from_numpy(np.array(v)).long()
                     for k, v in batch.items()})


def _rel_err(port_state, ref_leaves):
    scale = max(float(np.abs(r).max()) for r in ref_leaves)
    return max(float(np.abs(p.numpy() - r).max()) for p, r in zip(
        tree.leaves(port_state.opt_state.momentum), ref_leaves)) / scale


@pytest.mark.parametrize("robust,fed_kw", [
    (None, {}), ("per_client", {}),
    ("per_client", {"aggregator": "trimmed_mean"})])
def test_one_step_aggregated_grads_match_jax(model, robust, fed_kw):
    jc, tc, jp, batch = model
    js, jm = _jax_step(jc, jp, batch, fed_kw, robust)
    ref = [np.asarray(l) for l in
           jax.tree_util.tree_leaves(js.opt_state.momentum)]
    ps, pm = _port_step(tc, jp, batch, fed_kw, robust)
    assert _rel_err(ps, ref) <= REL
    for k in ("loss", "grad_norm", "acc"):
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    np.testing.assert_array_equal(ps.fed.team.numpy(),
                                  np.asarray(js.fed.team))
    if robust is None:
        # a client's rows swapped for client 0's: the aggregate moves
        swapped = {k: v.copy() for k, v in batch.items()}
        bc = B // C
        for k in swapped:
            swapped[k][-bc:] = batch[k][:bc]
        bad, _ = _port_step(tc, jp, swapped, fed_kw, robust)
        assert _rel_err(bad, ref) > REL
