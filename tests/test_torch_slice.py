"""The whole slice: the port's synchronous FedFiTS round against the JAX
package's ``fedfits.run(driver="python")`` on a reduced CNN (d_model=4,
d_ff=16), K=6, 3 rounds.

Both sides start from the same params (the JAX init, converted) and get
identical per-round batches, taken from the JAX ``Federation`` as numpy.
Team masks and h are exact every round; params, alpha and fitness scores
agree within atol 1e-5 (conv, matmul and the aggregation sums run in other
orders).  The comparison is against ``driver="python"``: the scan driver
is not bitwise to it on this jax install (ROADMAP queue 3).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.paper_models import CNN_CONFIG as JCNN
from repro.core import fedfits as jfedfits
from repro.data.pipeline import build_federation as jbuild_federation
from repro.models.model import build as jbuild
from repro_torch import interop, tree
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import fedfits
from repro_torch.models.model import build

K, ROUNDS, ATOL = 6, 3, 1e-5
FED = dict(n_clients=K, algorithm="fedfits", local_epochs=2, local_lr=0.05,
           msl=4, pft=2)


def _jax_run(aggregator):
    """JAX reference run; returns (init params, batches, history, per-round
    params), all as numpy."""
    jmodel = jbuild(JCNN.replace(d_model=4, d_ff=16))
    fed, _ = jbuild_federation(0, kind="images", n=600, n_clients=K,
                               batch_size=16, eval_batch=16)
    batches = []

    def data_fn(t, rng):
        b = fed.data_fn(t, rng)
        batches.append(jax.tree_util.tree_map(np.asarray, b))
        return b

    def eval_fn(params):
        return {f"p{i}": l for i, l in
                enumerate(jax.tree_util.tree_leaves(params))}

    rng = jax.random.PRNGKey(0)
    init = jmodel.init(jax.random.split(rng)[0])   # run()'s own r_init
    _, hist = jfedfits.run(jmodel, JFedConfig(aggregator=aggregator, **FED),
                           data_fn, ROUNDS, rng, eval_fn=eval_fn,
                           driver="python")
    return jax.tree_util.tree_map(np.asarray, init), batches, hist


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
def test_round_matches_jax_python_driver(aggregator):
    init, batches, hist = _jax_run(aggregator)
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    cfg = FedConfig(aggregator=aggregator, **FED)
    state = fedfits.init_state(interop.params_from_numpy(init), K, cfg,
                               torch.Generator().manual_seed(0))
    round_fn = fedfits.make_round(model, cfg)
    for t, (batch, ref) in enumerate(zip(batches, hist), start=1):
        state, m = round_fn(state, {k: torch.from_numpy(np.array(v))
                                    for k, v in batch.items()})
        np.testing.assert_array_equal(m["team"].numpy(), ref["team"],
                                      err_msg=f"team, round {t}")
        assert bool(m["h_next"]) == bool(ref["h_next"]), t
        np.testing.assert_allclose(float(m["alpha"]), float(ref["alpha"]),
                                   atol=ATOL)
        np.testing.assert_allclose(m["score"].numpy(), ref["score"],
                                   atol=ATOL)
        for i, leaf in enumerate(tree.leaves(state.params)):
            np.testing.assert_allclose(leaf.numpy(), ref[f"p{i}"], atol=ATOL,
                                       err_msg=f"leaf {i}, round {t}")
    assert state.round == ROUNDS + 1
    # the history includes a slot round that bills only the team
    assert float(state.cost_client_rounds) == sum(
        float(K if i == 0 or hist[i - 1]["h_next"] else r["team"].sum())
        for i, r in enumerate(hist))
