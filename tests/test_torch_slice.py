"""The whole slice: the port's synchronous FedFiTS round against the JAX
package's ``fedfits.run(driver="python")`` on a reduced CNN (d_model=4,
d_ff=16), K=6, 3 rounds; and the same round with the compressed uplink.

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
from repro_torch.comm import codecs
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG
from repro_torch.core import fedfits
from repro_torch.models.model import build

K, ROUNDS, ATOL = 6, 3, 1e-5
FED = dict(n_clients=K, algorithm="fedfits", local_epochs=2, local_lr=0.05,
           msl=4, pft=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU models under six test workers: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(aggregator, compress="none", rounds=ROUNDS):
    """JAX reference run; returns (init params, batches, history with the
    per-round params, final state), all as numpy."""
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
    state, hist = jfedfits.run(
        jmodel, JFedConfig(aggregator=aggregator, compress=compress, **FED),
        data_fn, rounds, rng, eval_fn=eval_fn, driver="python")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return to_np(init), batches, hist, to_np(state)


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
def test_round_matches_jax_python_driver(aggregator):
    init, batches, hist, _ = _jax_run(aggregator)
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


def _step(codec, layout, client_update, state, batch):
    """How far one flipped code moves a decoded coordinate this round: the
    largest int8/int4 scale, twice the largest signSGD magnitude, the
    largest kept top-k value.  The target is the round's update plus the
    EF residual, as the round encodes it."""
    local, _ = client_update(state.params, batch)
    flat = torch.cat([(a - b).reshape(K, -1) for a, b in
                      zip(tree.leaves(local), tree.leaves(state.params))], 1)
    enc = codec.encode_flat(flat + state.clients.ef, layout)
    if codec.name == "topk":
        return float(enc.val.abs().max())
    return float(enc.s.max()) * (2.0 if codec.name == "signsgd" else 1.0)


@pytest.mark.parametrize("compress,aggregator,rounds", [
    ("int8", "fedavg", 3), ("int8", "trimmed_mean", 3),
    ("int4", "trimmed_mean", 2), ("signsgd", "trimmed_mean", 2),
    ("topk", "trimmed_mean", 2)])
def test_compressed_round_matches_jax_python_driver(compress, aggregator,
                                                    rounds):
    """With ``compress``, error feedback on: teams, h, billed client-rounds
    and wire bytes are exact.  Params and the EF residual agree within one
    step of the codec (``_step``), not 1e-5: the port's and JAX's updates
    differ by ~1e-7, and where a coordinate sits on a rounding tie (or a
    sign or top-k boundary) that is enough to flip its code, which moves
    its decode, and so the aggregate and the residual, by one step."""
    init, batches, hist, jstate = _jax_run(aggregator, compress, rounds)
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    cfg = FedConfig(aggregator=aggregator, compress=compress, **FED)
    state = fedfits.init_state(interop.params_from_numpy(init), K, cfg,
                               torch.Generator().manual_seed(0))
    round_fn = fedfits.make_round(model, cfg)
    client_update = fedfits.make_client_update(model, cfg)
    codec = codecs.make_codec(cfg)
    layout = codec.layout([p.numel() for p in tree.leaves(state.params)])
    for t, (batch, ref) in enumerate(zip(batches, hist), start=1):
        batch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        step = _step(codec, layout, client_update, state, batch)
        state, m = round_fn(state, batch)
        np.testing.assert_array_equal(m["team"].numpy(), ref["team"],
                                      err_msg=f"team, round {t}")
        assert bool(m["h_next"]) == bool(ref["h_next"]), t
        for i, leaf in enumerate(tree.leaves(state.params)):
            np.testing.assert_allclose(leaf.numpy(), ref[f"p{i}"],
                                       atol=step + ATOL,
                                       err_msg=f"leaf {i}, round {t}")
    assert float(state.cost_client_rounds) == float(jstate.cost_client_rounds)
    assert float(state.cost_bytes_up) == float(jstate.cost_bytes_up)
    assert float(state.cost_bytes_down) == float(jstate.cost_bytes_down)
    np.testing.assert_allclose(state.clients.ef.numpy(),
                               interop.rows_from_numpy(jstate.clients.ef),
                               atol=step + ATOL)
