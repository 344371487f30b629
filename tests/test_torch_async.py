"""The whole slice: the port's buffered-async round against the JAX
package's ``make_async_round`` under ``jax.jit`` (as
``run_async(driver="python")`` runs it), 6 rounds with chronic stragglers,
so late deliveries park, retry, land and are abandoned.

Both sides start from the same params (the JAX init, converted) and the
same store and buffer.  Each round, the port's pure ``round_fn`` is fed the
draws that JAX derives from its own ``state.rng``: the cohort's Gumbel
noise, the batch indices and the delay uniforms.  Configs: ``paper-mlp`` on
the tabular federation (M=24, C=8, n=600, batch 16, one epoch at lr 0.2:
the JAX tests' ``_setup`` and ``_cfg``) and the reduced ``paper-cnn``
(d_model=4, d_ff=16) on images with the sync slice test's two epochs at
lr 0.05, under trimmed_mean and fedavg, stragglers at the head or the tail
rows, through the segmented route and K7's (its plain version on the CPU).

The CNN keeps the sync slice's local SGD because at the MLP's lr 0.2 its
round 2 puts a dense pre-activation within 1e-7 of zero (three copies of
one image in a client's batch): there the summation order decides the
ReLU, and the port's vmapped forward (+3.3e-8), its unvmapped forward
(-1.2e-8) and JAX's (-1.0e-7) disagree in sign, so one client's update
moves by 1e-2.  That is a decision at the boundary, not a fault of either
package (ROADMAP queue 3).

Exact: the cohort, the on-time mask, the due and exhausted rows, the
buffer's owner/age/active, staleness, failures, cum_selected and billing.
Within 1e-5: params, parked rows, trust, gate_trust and fitness (local SGD
and the aggregation sums run in other orders); ``remaining`` within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.registry import ARCHS
from repro.core import async_engine as jae
from repro.core import clientstore as jcs
from repro.core import faults as jfaults
from repro.data.pipeline import build_federation as jbuild_federation
from repro.models.model import build as jbuild
from repro_torch import interop, tree
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import CNN_CONFIG, MLP_CONFIG
from repro_torch.core import async_engine as ae
from repro_torch.core import faults
from repro_torch.models.model import build

M, C, ROUNDS, ATOL = 24, 8, 6, 1e-5
LATE = dict(straggler_frac=0.3, straggler_delay=3.0, base_delay=0.3)
FED = dict(n_clients=C, population=M, algorithm="fedavg", local_epochs=1,
           local_lr=0.2, async_max_retries=2, staleness_decay=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU models under six test workers: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    """(JAX model, port model, JAX federation, FedConfig fields) for the
    two configs."""
    if arch == "mlp":
        fed, _ = jbuild_federation(0, kind="tabular", n=600, n_clients=M,
                                   batch_size=16, n_classes=10, sep=1.0,
                                   dirichlet_alpha=1.0)
        return jbuild(ARCHS["paper-mlp"]), build(MLP_CONFIG), fed, FED
    fed, _ = jbuild_federation(0, kind="images", n=600, n_clients=M,
                               batch_size=16, dirichlet_alpha=1.0)
    small = dict(d_model=4, d_ff=16)
    return (jbuild(ARCHS["paper-cnn"].replace(**small)),
            build(CNN_CONFIG.replace(**small)), fed,
            dict(FED, local_epochs=2, local_lr=0.05))


def _jax_draws(jcfg, scales, cap, ecap):
    """A jitted function of the pre-round JAX state: the draws JAX's round
    takes from ``state.rng``, and JAX's own cohort, on-time mask, due and
    exhausted rows for them."""

    def fn(jstate):
        _, r_sel, _, r_data, _, r_delay = jax.random.split(jstate.rng, 6)
        kb, ke = jax.random.split(jax.random.fold_in(r_data, 3))
        r_u = jax.random.fold_in(r_delay, 11)
        draws = {
            "gumbel": jax.random.gumbel(r_sel, (M,), jnp.float32),
            "bi": jax.random.randint(kb, (C, min(16, cap)), 0, cap),
            "ei": jax.random.randint(ke, (C, min(32, ecap)), 0, ecap),
            "u_delay": jax.random.uniform(r_u, (C,), minval=1e-7,
                                          maxval=1.0),
        }
        idx = jcs.select_cohort(jstate.clients, C, r_sel,
                                method=jcfg.select_method)
        delay = jfaults.sample_delays(scales[idx], r_u)
        buf = jstate.buf
        window = jcfg.async_deadline \
            * jcfg.async_backoff ** buf.age.astype(jnp.float32)
        due = buf.active * (buf.remaining <= window).astype(jnp.float32)
        exhausted = buf.active * (1.0 - due) * (
            buf.age >= jcfg.async_max_retries).astype(jnp.float32)
        ref = {"cohort": idx,
               "on_time": (delay <= jcfg.async_deadline).astype(jnp.float32),
               "due": due, "exhausted": exhausted}
        return draws, ref

    jfn = jax.jit(fn)

    def call(jstate):
        draws, ref = jfn(jstate)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
        draws["bi"], draws["ei"] = draws["bi"].long(), draws["ei"].long()
        return draws, {k: np.asarray(v) for k, v in ref.items()}

    return call


@functools.lru_cache(maxsize=None)
def _case(arch, aggregator, rows, method):
    """Both sides of one config, the JAX round and draws jitted once per
    test process: (JAX model, port model, federation, JAX config, JAX
    round, JAX draws, port round_fn, port config)."""
    jmodel, model, fed, kw = _setup(arch)
    jcfg = JFedConfig(aggregator=aggregator, select_method=method, **kw)
    cfg = FedConfig(aggregator=aggregator, select_method=method, **kw)
    jfl, fl = jfaults.FaultConfig(**LATE), faults.FaultConfig(**LATE)
    jround = jax.jit(jae.make_async_round(
        jmodel, jcfg, fed.data, batch_size=16, faults=jfl,
        straggler_rows=rows))
    jdraws = _jax_draws(jcfg, jfaults.delay_scales(jfl, M, rows=rows),
                        fed.data["x"].shape[1], fed.data["eval_x"].shape[1])
    pop = {k: torch.from_numpy(np.array(v)) for k, v in fed.data.items()}
    _, round_fn = ae.make_async_round(model, cfg, pop, batch_size=16,
                                      faults=fl, straggler_rows=rows)
    return jmodel, model, fed, jcfg, jround, jdraws, round_fn, cfg


def _close(a, b, atol, what):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol,
                               err_msg=what)


def _exact(a, b, what):
    b = np.asarray(b)
    np.testing.assert_array_equal(np.asarray(a).astype(b.dtype), b,
                                  err_msg=what)


@pytest.mark.parametrize("arch,aggregator,rows,method", [
    ("mlp", "trimmed_mean", "head", "segmented"),
    ("mlp", "trimmed_mean", "tail", "pallas"),
    ("mlp", "fedavg", "head", "pallas"),
    ("mlp", "fedavg", "tail", "segmented"),
    ("cnn", "trimmed_mean", "tail", "pallas"),
    ("cnn", "fedavg", "head", "segmented"),
])
def test_async_round_matches_jax(arch, aggregator, rows, method):
    jmodel, _, _, jcfg, jround, jax_draws, round_fn, cfg = _case(
        arch, aggregator, rows, method)
    r_init, r_run = jax.random.split(jax.random.PRNGKey(0))
    jstate = jae.init_async_state(jax.jit(jmodel.init)(r_init), jcfg, r_run)
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate.params))
    state = ae.init_async_state(params, cfg, torch.Generator())
    seen = {"buffered": 0.0, "due": 0.0, "abandoned": 0.0}
    for t in range(1, ROUNDS + 1):
        draws, ref = jax_draws(jstate)
        jstate, jm = jround(jstate, {})
        state, m = round_fn(state, draws)
        for k in ref:
            _exact(m[k], ref[k], f"{k}, round {t}")
        for k in ("buffered", "abandoned", "delivered", "guard_rejected",
                  "buf_fill"):
            assert float(m[k]) == float(jm[k]), (k, t)
        seen["buffered"] += float(m["buffered"])
        seen["abandoned"] += float(m["abandoned"])
        seen["due"] += float(m["due"].sum())
        jb, b = jstate.buf, state.buf
        for k in ("owner", "age", "active"):
            _exact(getattr(b, k), getattr(jb, k), f"buf.{k}, round {t}")
        _close(b.remaining, jb.remaining, 1e-6, f"remaining, round {t}")
        _close(b.upd, interop.rows_from_numpy(
            jax.tree_util.tree_map(np.asarray, jb.upd)), ATOL,
            f"parked rows, round {t}")
        jc, cs = jstate.clients, state.clients
        for k in ("staleness", "failures", "cum_selected"):
            _exact(getattr(cs, k), getattr(jc, k), f"{k}, round {t}")
        for k in ("trust", "gate_trust", "fitness"):
            _close(getattr(cs, k), getattr(jc, k), ATOL, f"{k}, round {t}")
        for i, (a, b_) in enumerate(zip(
                tree.leaves(state.params),
                jax.tree_util.tree_leaves(jstate.params))):
            _close(a, b_, ATOL, f"leaf {i}, round {t}")
        for k in ("cost_client_rounds", "cost_bytes_up", "cost_bytes_down"):
            assert float(getattr(state, k)) == float(getattr(jstate, k)), k
    assert state.round == ROUNDS + 1
    # the stragglers exercised every buffer path
    assert seen["buffered"] > 0 and seen["due"] > 0 and seen["abandoned"] > 0


def test_round_from_jax_mid_run_state():
    """The port takes over JAX's state after 3 rounds (params, store and a
    buffer holding parked rows, through ``interop``) and runs 2 more
    rounds on JAX's draws: the same cohorts, buffer and params as JAX's."""
    jmodel, _, _, jcfg, jround, jax_draws, round_fn, cfg = _case(
        "mlp", "trimmed_mean", "tail", "pallas")
    r_init, r_run = jax.random.split(jax.random.PRNGKey(4))
    jstate = jae.init_async_state(jax.jit(jmodel.init)(r_init), jcfg, r_run)
    for _ in range(3):
        jstate, _ = jround(jstate, {})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    assert float(jstate.buf.active.sum()) > 0          # rows are parked
    params = interop.params_from_numpy(to_np(jstate.params))
    state = ae.init_async_state(params, cfg, torch.Generator())._replace(
        clients=interop.store_from_numpy(to_np(jstate.clients)),
        buf=interop.buffer_from_numpy(to_np(jstate.buf), params, cfg),
        round=torch.tensor(4, dtype=torch.int32),
        cost_client_rounds=torch.tensor(
            float(jstate.cost_client_rounds)))
    _exact(state.buf.upd, interop.rows_from_numpy(to_np(jstate.buf.upd)),
           "converted parked rows")
    for t in (4, 5):
        draws, ref = jax_draws(jstate)
        jstate, _ = jround(jstate, {})
        state, m = round_fn(state, draws)
        for k in ref:
            _exact(m[k], ref[k], f"{k}, round {t}")
        for k in ("owner", "age", "active"):
            _exact(getattr(state.buf, k), getattr(jstate.buf, k),
                   f"buf.{k}, round {t}")
        for a, b_ in zip(tree.leaves(state.params),
                         jax.tree_util.tree_leaves(jstate.params)):
            _close(a, b_, ATOL, f"params, round {t}")
    assert float(state.cost_client_rounds) == float(jstate.cost_client_rounds)


def test_run_async_on_cpu_bills_every_cohort_row():
    """The entry point on the CPU: C client-rounds and C dense uplinks a
    round, whatever was late, buffered or abandoned."""
    _, model, fed, _ = _setup("mlp")
    cfg = FedConfig(aggregator="trimmed_mean", **FED)
    pop = {k: torch.from_numpy(np.array(v)) for k, v in fed.data.items()}
    state, hist = ae.run_async(model, cfg, pop, 4, seed=3, batch_size=16,
                               device="cpu", faults=faults.FaultConfig(**LATE))
    n = sum(p.numel() for p in tree.leaves(state.params))
    assert len(hist) == 4 and [h["round"] for h in hist] == [1, 2, 3, 4]
    assert float(state.cost_client_rounds) == 4 * C
    assert float(state.cost_bytes_up) == 4 * C * 4 * n
    assert all(np.isfinite(h["wall_ms"]) for h in hist)
    assert all(len(set(h["cohort"].tolist())) == C for h in hist)
    assert all(bool(torch.isfinite(p).all()) for p in tree.leaves(state.params))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.floats(0.5, 200.0), st.floats(0.0, 1.0),
                          st.sampled_from([0.0, 1.0]), st.integers(0, 4)),
                min_size=1, max_size=20),
       st.floats(0.05, 1.0))
def test_delivery_weights_are_convex(rows, decay):
    """Entries in [0, 1], zero where masked out, summing to 1 whenever the
    round's raw mass n_k * trust * decay^age reaches the 1e-12 floor of
    ``normalize_weights`` (below it they sum to less, as in JAX); and equal
    to JAX's weights."""
    n_k, trust, mask, age = (torch.tensor(c) for c in zip(*rows))
    w = ae.delivery_weights(n_k.float(), trust.float(), mask.float(),
                            age.to(torch.int32), staleness_decay=decay)
    ref = jae.delivery_weights(
        jnp.asarray(n_k.numpy(), jnp.float32),
        jnp.asarray(trust.numpy(), jnp.float32),
        jnp.asarray(mask.numpy(), jnp.float32),
        jnp.asarray(age.numpy(), jnp.int32), staleness_decay=decay)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-7)
    assert bool((w >= 0).all()) and bool((w <= 1.0 + 1e-6).all())
    assert bool((w[mask == 0] == 0).all())
    raw = float((n_k * trust * decay ** age.double() * mask).sum())
    total = float(w.sum())
    assert total <= 1.0 + 1e-5
    if raw >= 1e-11:
        assert abs(total - 1.0) < 1e-5
