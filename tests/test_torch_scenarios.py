"""The scenario matrix of the port (``repro_torch.scenarios``) against the
JAX package's, and the port's rounds under its attacks and faults.

  * the registry equals JAX's field by field (``fed_config`` too) and the
    smoke grid has the same 22 names;
  * the sync round on eight cells, fed JAX's batches and JAX's fault
    draws, 3 rounds, against JAX's round as ``fedfits.run(driver="python")``
    runs it (jitted, one call a round).  Two variants exercise what the
    named cells do not reach on this federation in 3 rounds:
    ``hetero_fedfits+partial0.1`` sets ``partial_min_frac=0.1`` (at the
    scenarios' E = 2 the cell's own 0.5 gives ceil(2 U[0.5, 1)) = 2 epochs
    always, so no client stops early), and ``signflip_fedfits+gate0`` sets
    the cosine gate to 0.  The named ``signflip_fedfits`` runs beside it as
    the reference's witness: JAX's round gates no client there either (at
    -0.5 the flippers' cosine to the median stays above the threshold), so
    its gate-trust demotion and election path need the variant;
  * the async round on ``async_late_poison`` (head stragglers, the
    cross-round attacker), 4 rounds, against JAX's jitted round, fed JAX's
    draws, as ``tests/test_torch_async.py`` does;
  * ``run_scenario`` on the CPU: two runs of a cell give the same summary,
    whose keys are JAX's, the telemetry (``obs_*``) ones included.

Every round runs ``paper-mlp`` on the scenarios' tabular federation (their
default model; ``fed_config``'s local lr 0.2 puts a reduced CNN's
pre-activations within rounding of the ReLU's kink, ROADMAP queue 3).

Exact: teams, cohorts, the avail / lost / effective-epoch masks, the gated
fraction, billing and the async buffer.  Within 1e-5: params, alpha,
gate_trust and the attacker's blend (local SGD and the aggregation sums
run in other orders); under int8, params within one quantisation step
(a code on a rounding tie may flip, as in ``tests/test_torch_slice.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.core import async_engine as jae
from repro.core import clientstore as jcs
from repro.core import faults as jfaults
from repro.core import fedfits as jfedfits
from repro.data.pipeline import build_federation as jbuild_federation
from repro.models.model import build as jbuild
from repro.scenarios import engine as jengine
from repro.scenarios import registry as jregistry
from repro_torch import interop, tree
from repro_torch.core import async_engine as ae
from repro_torch.core import faults
from repro_torch.core import fedfits
from repro_torch.scenarios import engine, registry

K, N_DATA, ATOL = 10, 600, 1e-5
SYNC_CELLS = ["hetero_fedfits", "dropout_trimmed", "alie_fedfits",
              "cross_round_trimmed", "gate_aware_int8_dropout",
              "signflip_fedfits", "hetero_fedfits+partial0.1",
              "signflip_fedfits+gate0"]
VARIANTS = {   # suffix -> Scenario.replace fields of both packages' cell
    "partial0.1": lambda sc: dict(faults=dataclasses.replace(
        sc.faults, partial_min_frac=0.1)),
    "gate0": lambda sc: dict(fed=(("cosine_outlier_thresh", 0.0),)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU models under six test workers: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _fields(obj):
    out = dataclasses.asdict(obj)
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in out.items()}


def test_registry_equals_jax():
    jall, pall = jregistry.all_scenarios(), registry.all_scenarios()
    assert list(pall) == list(jall)
    assert len(registry.smoke_grid()) == 22
    assert list(registry.smoke_grid()) == list(jregistry.smoke_grid())
    for name, jsc in jall.items():
        psc = registry.get(name)
        assert _fields(psc) == _fields(jsc), name
        for k in (10, 16):
            assert dataclasses.asdict(psc.fed_config(k)) \
                == dataclasses.asdict(jsc.fed_config(k)), (name, k)
    with pytest.raises(KeyError):
        registry.get("no_such_cell")


def _jax_setup(sc, k=K, pop=None):
    """JAX's side of one cell, as its ``run_scenario`` builds it."""
    cfg = sc.fed_config(k)
    pop = pop or k
    if sc.async_mode:
        cfg = dataclasses.replace(cfg, population=pop)
    model = jbuild(ARCHS["paper-mlp"])
    fed, _ = jbuild_federation(0, kind="tabular", n=N_DATA, n_clients=pop,
                               batch_size=32, n_classes=10, sep=1.0,
                               dirichlet_alpha=1.0)
    n_mal = max(int(round(sc.mal_frac * pop)), 1) if sc.attack != "none" \
        else 0
    mal = jnp.zeros((pop,)).at[jnp.arange(n_mal)].set(1.0) if n_mal \
        else None
    data_attack, update_attack = jengine.make_attack_fns(sc, cfg, 10)
    return cfg, model, fed, mal, data_attack, update_attack


def _jax_fault_draws(rng, fl, e):
    """The uniforms JAX's round folds off its own streams, and JAX's own
    arrival and epoch masks for them."""
    _, r_data, _, r_sel, r_cli = jax.random.split(rng, 5)
    out, ref = {}, {}
    if fl.stragglers_active:
        key = jax.random.fold_in(r_data, 11)
        out["u_arrive"] = jax.random.uniform(key, (K,), minval=1e-7,
                                             maxval=1.0)
        ref["arrive"] = jfaults.sample_arrivals(fl, key, K)
    if fl.partial_active:
        key = jax.random.fold_in(r_cli, 13)
        out["epoch_frac"] = jax.random.uniform(
            key, (K,), minval=fl.partial_min_frac, maxval=1.0)
        ref["eff"] = jfaults.sample_epochs(fl, key, K, e)
    if fl.dropout_active:
        out["u_drop"] = jax.random.uniform(jax.random.fold_in(r_sel, 12),
                                           (K,))
        ref["r_sel"] = r_sel
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}, ref


def _int8_step(s, state, batch, draws):
    """One quantisation step of this round: the largest block scale an int8
    code can have, max |attacked update + EF residual| / 127."""
    cfg = s.fed_cfg
    fl = s.scenario.faults
    client_update = fedfits.make_client_update(s.model, cfg)
    eff = faults.sample_epochs(draws["epoch_frac"], cfg.local_epochs) \
        if fl.partial_active else None
    local, _ = client_update(state.params, batch, eff)
    flat = torch.cat([(a - b).reshape(K, -1) for a, b in
                      zip(tree.leaves(local), tree.leaves(state.params))], 1)
    flat = s.update_attack(flat, s.malicious, None)
    return float((flat + state.clients.ef).abs().max()) / 127.0


def _cells(cell):
    """(JAX scenario, port scenario) of a cell name, with a ``VARIANTS``
    suffix applied to both."""
    name, _, variant = cell.partition("+")
    jsc, sc = jregistry.get(name), registry.get(name)
    if variant:
        jsc = jsc.replace(**VARIANTS[variant](jsc))
        sc = sc.replace(**VARIANTS[variant](sc))
    return jsc, sc


@pytest.mark.parametrize("cell", SYNC_CELLS)
def test_sync_round_matches_jax_on_cell(cell):
    jsc, sc = _cells(cell)
    jcfg, jmodel, fed, jmal, jdata_attack, jupdate_attack = _jax_setup(jsc)
    s = engine.setup(sc, n_clients=K, device="cpu")
    fl, e = s.scenario.faults, s.fed_cfg.local_epochs
    rng = jax.random.PRNGKey(1)
    r_init, r_run = jax.random.split(rng)
    jparams = jmodel.init(r_init)
    jatt = jupdate_attack if getattr(jupdate_attack, "stateful", False) \
        else None
    jstate = jfedfits.init_state(jparams, K, jcfg, r_run, attacker=jatt)
    jround = jax.jit(jfedfits.make_round(
        jmodel, jcfg, data_attack=jdata_attack,
        update_attack=jupdate_attack, malicious=jmal, faults=jsc.faults))
    state = fedfits.init_state(
        interop.params_from_numpy(_np(jparams)), K, s.fed_cfg,
        torch.Generator().manual_seed(0),
        attacker=s.update_attack if jatt is not None else None)
    round_fn = fedfits.make_round(
        s.model, s.fed_cfg, data_attack=s.data_attack,
        update_attack=s.update_attack, malicious=s.malicious, faults=fl)
    seen = {"lost": 0.0, "gated": 0.0, "short": 0.0}
    for t in range(1, 4):
        jbatch = fed.data_fn(t, jax.random.fold_in(rng, t))
        batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
        draws, jref = _jax_fault_draws(jstate.rng, jsc.faults, e)
        step = _int8_step(s, state, batch, draws) \
            if s.fed_cfg.compress == "int8" else 0.0
        jstate, jm = jround(jstate, jbatch)
        state, m = round_fn(state, batch, draws)
        what = f"{cell}, round {t}"
        np.testing.assert_array_equal(m["team"].numpy(),
                                      np.asarray(jm["team"]), err_msg=what)
        if "arrive" in jref:
            np.testing.assert_array_equal(m["avail"].numpy(),
                                          np.asarray(jref["arrive"]))
        if "eff" in jref:
            np.testing.assert_array_equal(m["eff_epochs"].numpy(),
                                          np.asarray(jref["eff"]))
        if "r_sel" in jref:
            lost = jfaults.sample_dropout(
                jsc.faults, jax.random.fold_in(jref["r_sel"], 12),
                jm["team"])
            np.testing.assert_array_equal(m["lost"].numpy(),
                                          np.asarray(lost))
        for key in ("fault_lost", "gated_frac", "guard_rejected",
                    "team_size"):
            assert float(m[key]) == float(jm[key]), (key, what)
        # a mean of the exact counts above, rounded in another order
        np.testing.assert_allclose(float(m["fault_eff_epochs"]),
                                   float(jm["fault_eff_epochs"]), rtol=1e-6)
        seen["lost"] += float(m["fault_lost"])
        seen["gated"] += float(m["gated"].sum())
        seen["short"] += float((m["eff_epochs"] < e).sum())
        np.testing.assert_allclose(float(m["alpha"]), float(jm["alpha"]),
                                   atol=ATOL)
        np.testing.assert_allclose(m["gate_trust"].numpy(),
                                   np.asarray(jm["gate_trust"]), atol=ATOL,
                                   err_msg=what)
        for leaf, jleaf in zip(tree.leaves(state.params),
                               jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf),
                                       atol=ATOL + step, err_msg=what)
        if jatt is not None:
            np.testing.assert_allclose(float(state.attacker[0]),
                                       float(jstate.attacker[0]), atol=ATOL)
            np.testing.assert_array_equal(state.attacker[1].numpy(),
                                          np.asarray(jstate.attacker[1]))
    assert float(state.cost_client_rounds) == float(jstate.cost_client_rounds)
    assert float(state.cost_bytes_up) == float(jstate.cost_bytes_up)
    # each cell exercises what it is about
    assert (seen["lost"] > 0) == fl.dropout_active
    assert (seen["short"] > 0) == cell.endswith("partial0.1")
    assert (seen["gated"] > 0) == cell.endswith("gate0")


# ---------------------------------------------------------------- async ----

C_ASYNC = 8


def _jax_async_draws(jcfg, scales, cap, ecap, bsz, esz):
    m, c = jcfg.population, jcfg.n_clients

    def fn(jstate):
        _, r_sel, _, r_data, _, r_delay = jax.random.split(jstate.rng, 6)
        kb, ke = jax.random.split(jax.random.fold_in(r_data, 3))
        r_u = jax.random.fold_in(r_delay, 11)
        draws = {
            "gumbel": jax.random.gumbel(r_sel, (m,), jnp.float32),
            "bi": jax.random.randint(kb, (c, min(bsz, cap)), 0, cap),
            "ei": jax.random.randint(ke, (c, min(esz, ecap)), 0, ecap),
            "u_delay": jax.random.uniform(r_u, (c,), minval=1e-7,
                                          maxval=1.0),
        }
        idx = jcs.select_cohort(jstate.clients, c, r_sel,
                                method=jcfg.select_method)
        delay = jfaults.sample_delays(scales[idx], r_u)
        return draws, {"cohort": idx,
                       "on_time": (delay <= jcfg.async_deadline).astype(
                           jnp.float32)}

    jfn = jax.jit(fn)

    def call(jstate):
        draws, ref = jfn(jstate)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
        draws["bi"], draws["ei"] = draws["bi"].long(), draws["ei"].long()
        return draws, {k: np.asarray(v) for k, v in ref.items()}

    return call


def test_async_round_matches_jax_on_late_poison():
    cell = "async_late_poison"
    jsc = jregistry.get(cell)
    pop = 3 * C_ASYNC
    jcfg, jmodel, fed, jmal, jdata_attack, jupdate_attack = _jax_setup(
        jsc, k=C_ASYNC, pop=pop)
    s = engine.setup(cell, n_clients=C_ASYNC, device="cpu")
    assert s.population == pop and s.fed_cfg == dataclasses.replace(
        s.scenario.fed_config(C_ASYNC), population=pop)
    jround = jax.jit(jae.make_async_round(
        jmodel, jcfg, fed.data, batch_size=fed.batch_size,
        eval_batch=fed.eval_batch, data_attack=jdata_attack,
        update_attack=jupdate_attack, malicious=jmal, faults=jsc.faults,
        straggler_rows=jsc.straggler_rows))
    jdraws = _jax_async_draws(
        jcfg, jfaults.delay_scales(jsc.faults, pop, rows="head"),
        fed.data["x"].shape[1], fed.data["eval_x"].shape[1], fed.batch_size,
        fed.eval_batch)
    r_init, r_run = jax.random.split(jax.random.PRNGKey(1))
    jparams = jmodel.init(r_init)
    jstate = jae.init_async_state(jparams, jcfg, r_run,
                                  attacker=jupdate_attack)
    pop_data = {k: torch.from_numpy(np.array(v)) for k, v in fed.data.items()}
    _, round_fn = ae.make_async_round(
        s.model, s.fed_cfg, pop_data, batch_size=fed.batch_size,
        eval_batch=fed.eval_batch, data_attack=s.data_attack,
        update_attack=s.update_attack, malicious=s.malicious,
        faults=s.scenario.faults, straggler_rows=s.scenario.straggler_rows)
    state = ae.init_async_state(interop.params_from_numpy(_np(jparams)),
                                s.fed_cfg, torch.Generator(),
                                attacker=s.update_attack)
    state = state._replace(attacker=interop.attacker_from_numpy(
        _np(jstate.attacker)))
    parked = 0
    for t in range(1, 5):
        draws, ref = jdraws(jstate)
        jstate, jm = jround(jstate, {})
        state, m = round_fn(state, draws)
        what = f"round {t}"
        np.testing.assert_array_equal(m["cohort"].numpy(), ref["cohort"],
                                      err_msg=what)
        np.testing.assert_array_equal(m["on_time"].numpy(), ref["on_time"],
                                      err_msg=what)
        for k in ("owner", "age", "active"):
            np.testing.assert_array_equal(getattr(state.buf, k).numpy(),
                                          np.asarray(getattr(jstate.buf, k)),
                                          err_msg=f"{k}, {what}")
        for key in ("delivered", "buffered", "abandoned", "gated_frac"):
            assert float(m[key]) == float(jm[key]), (key, what)
        np.testing.assert_allclose(float(state.attacker[0]),
                                   float(jstate.attacker[0]), atol=ATOL)
        np.testing.assert_array_equal(state.attacker[1].numpy(),
                                      np.asarray(jstate.attacker[1]))
        np.testing.assert_allclose(state.clients.gate_trust.numpy(),
                                   np.asarray(jstate.clients.gate_trust),
                                   atol=ATOL)
        for leaf, jleaf in zip(tree.leaves(state.params),
                               jax.tree_util.tree_leaves(jstate.params)):
            np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf),
                                       atol=ATOL, err_msg=what)
        np.testing.assert_allclose(
            state.buf.upd.numpy(),
            interop.rows_from_numpy(_np(jstate.buf.upd)).numpy(), atol=ATOL)
        parked += float(m["buffered"])
    assert parked > 0                 # the late poison went through the buffer
    assert float(state.cost_client_rounds) == float(jstate.cost_client_rounds)


# -------------------------------------------------------- run_scenario ----

def test_run_scenario_repeats_and_keys():
    kw = dict(n_clients=K, n_rounds=2, n=400, device="cpu")
    a, hist = engine.run_scenario("cross_round_trimmed", **kw)
    b, _ = engine.run_scenario("cross_round_trimmed", **kw)
    a.pop("wall_s"), b.pop("wall_s")
    assert a == b
    assert len(hist) == 2 and a["rounds"] == 2
    state = type("S", (), {"gate_trust": jnp.ones(K),
                           "cost_client_rounds": 1.0,
                           "cost_bytes_up": 1.0})()
    row = {"test_acc": 0.5, "trigger_acc": 0.1, "fair_acc_var": 0.0,
           "fair_worst_decile": 0.0, "fair_part_gini": 0.0,
           "gated_frac": 0.0}
    jkeys = set(jengine.summarize(jregistry.get("cross_round_trimmed"),
                                  state, [row], 3, 0.0))
    assert set(a) | {"wall_s"} == jkeys | {"obs_rows", "obs_warnings",
                                           "obs_warning_counts"}
    assert a["obs_rows"] == 2
    # the default driver is the chunked one; the per-round loop agrees
    c, _ = engine.run_scenario("cross_round_trimmed", driver="python", **kw)
    c.pop("wall_s")
    assert c == a
    with pytest.raises(ValueError, match="driver"):
        engine.run_scenario("clean_trimmed", driver="jit", **kw)
    # telemetry=False opts out: no obs keys in the summary or the rows
    d, dh = engine.run_scenario("cross_round_trimmed", telemetry=False, **kw)
    assert set(d) == jkeys
    assert not [k for k in dh[0] if k.startswith("obs/")]
