"""The telemetry layer (``repro_torch/obs``) against the JAX package's
``repro/obs``, and through the port's engines on the CPU.

  * The registry is the JAX package's, field by field; ``quantiles`` and
    ``age_histogram`` are bitwise JAX's (ties, +-0.0, n = 1, NaN);
    ``rejection_kinds`` equals JAX's on rows that fail each rule.
  * Sync: the port's round, fed JAX's init, batches and availability,
    publishes the ``obs/`` values of JAX's telemetry-on
    ``fedfits.run(driver="python")`` (the tabular federation of
    ``tests/test_obs.py``): counters exactly, masses within rtol 1e-5 and
    the quantile gauges within 1e-5 (trust and fitness run in another
    summation order).
  * Async: the port's round, fed JAX's draws, on ``tests/test_obs.py``'s
    seed-4, 8-round setup, where rows park: counters and the retry-age
    histogram exactly, masses and gauges as above; and the same
    reconciliations that test makes, on the port's own run.
  * On/off: with telemetry the port's run is bit for bit the run without
    it (params, generator, billing and every non-``obs/`` history value)
    under both drivers, sync and async.
  * ``run_scenario``'s default summary has the JAX package's keys.
  * The JSONL and trace artifacts of sync and async runs pass both the
    JAX package's ``python -m repro.obs.check --require-obs --min-phases
    5`` and the port's ``python -m repro_torch.obs.check`` (their
    ``main``), with the same findings: none, and the same one for a
    stream without its summary.
  * Monitors, sinks and the trace recorder, as ``tests/test_obs.py``
    holds the JAX package's.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.registry import ARCHS
from repro.core import async_engine as jae
from repro.core import faults as jfaults
from repro.core import fedfits as jfedfits
from repro.core.aggregation import rejection_kinds as jrejection_kinds
from repro.data.pipeline import build_federation as jbuild_federation
from repro.models.model import build as jbuild
from repro.obs import MemorySink as JMemorySink
from repro.obs import Telemetry as JTelemetry
from repro.obs import check as jcheck
from repro.obs import counters as jcounters
from repro.scenarios import engine as jscenarios
from repro_torch import interop, tree
from repro_torch.configs.base import FedConfig
from repro_torch.configs.paper_models import MLP_CONFIG
from repro_torch.core import aggregation, async_engine, driver, fedfits
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import build_federation
from repro_torch.models.model import build
from repro_torch.obs import (JsonlSink, MemorySink, MultiSink, Telemetry,
                             counters, jsonable)
from repro_torch.obs import check
from repro_torch.obs.check import check_trace
from repro_torch.obs.monitors import Monitor, MonitorBank
from repro_torch.obs.trace import PHASE_NAMES, TraceRecorder
from repro_torch.scenarios import run_scenario

RTOL = ATOL = 1e-5
SYNC = dict(n_clients=6, algorithm="fedfits", local_epochs=1, local_lr=0.05,
            avail_prob=0.7, aggregator="trimmed_mean")
ASYNC = dict(n_clients=4, population=12, algorithm="fedavg",
             aggregator="trimmed_mean", local_epochs=1, local_lr=0.2,
             async_max_retries=2, staleness_decay=0.5)
LATE = dict(straggler_frac=0.3, straggler_delay=3.0, base_delay=0.3)
# counters compared exactly; the rest within RTOL / ATOL
EXACT = ("gate/cosine_rejected", "guard/nonfinite", "guard/norm",
         "select/team_size", "select/available", "delivery/on_time",
         "delivery/late", "buffer/occupancy", "buffer/parked",
         "buffer/overflow", "buffer/exhausted", "buffer/age_hist",
         "wire/bytes_up", "wire/bytes_down", "fault/lost")


# ------------------------------------------------------------ registry ----

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU models under six test workers: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_registry_is_the_jax_packages():
    assert list(counters.REGISTRY) == list(jcounters.REGISTRY)
    for name, spec in counters.REGISTRY.items():
        j = jcounters.REGISTRY[name]
        assert (spec.kind, spec.engines, spec.shape, spec.unit, spec.doc) \
            == (j.kind, j.engines, j.shape, j.unit, j.doc), name
    assert counters.QUANTILE_PROBS == jcounters.QUANTILE_PROBS
    cfg = FedConfig(async_max_retries=3)
    for engine in ("sync", "async", "serve"):
        col = counters.init_column(engine, cfg)
        jcol = jcounters.init_column(engine, JFedConfig(async_max_retries=3))
        assert sorted(col) == sorted(jcol)
        for k, v in col.items():
            assert tuple(v.shape) == jcol[k].shape and v.dtype == torch.float32


def _quantile_cases():
    rng = np.random.default_rng(0)
    cases = [np.array([0.3], np.float32), np.array([-0.0], np.float32),
             np.array([0.0, -0.0, 0.0], np.float32),
             np.array([-1.0, 0.0, -0.0], np.float32),
             np.array([1.0, np.nan, 2.0], np.float32),
             np.full(7, 0.25, np.float32)]
    for n in (2, 3, 5, 6, 10, 16, 48):
        cases.append(rng.standard_normal(n).astype(np.float32))
        cases.append(rng.integers(0, 3, n).astype(np.float32))  # ties
        cases.append(rng.choice(np.array([0.0, -0.0, 1.0, -1.0],
                                         np.float32), n))
        cases.append((rng.random(n) * rng.choice([1e-30, 1.0, 1e30], n))
                     .astype(np.float32))
    return cases


def test_quantiles_bitwise_jnp_quantile():
    for x in _quantile_cases():
        want = np.asarray(jcounters.quantiles(jnp.asarray(x)))
        got = counters.quantiles(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=str(x))


def test_age_histogram_bitwise_jax():
    rng = np.random.default_rng(1)
    for retries in (0, 1, 2, 5):
        for _ in range(5):
            age = rng.integers(0, retries + 2, 12).astype(np.int32)
            active = rng.integers(0, 2, 12).astype(np.float32)
            want = np.asarray(jcounters.age_histogram(
                jnp.asarray(age), jnp.asarray(active),
                JFedConfig(async_max_retries=retries)))
            got = counters.age_histogram(
                torch.from_numpy(age), torch.from_numpy(active),
                FedConfig(async_max_retries=retries)).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("norm_mult", [1e4, 3.0, 0.0])
def test_rejection_kinds_match_jax(norm_mult):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 50)).astype(np.float32)
    x[1, 3] = np.nan
    x[2] *= 1e6                         # an absurd norm
    x[4, 0] = np.inf
    x[4] *= 1e6                         # fails both: counts as nonfinite
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32)
    want = jrejection_kinds({"u": jnp.asarray(x)}, jnp.asarray(mask),
                            norm_mult=norm_mult)
    got = aggregation.rejection_kinds({"u": torch.from_numpy(x)},
                                      torch.from_numpy(mask),
                                      norm_mult=norm_mult)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    clean, cmask, rejected = aggregation.sanitize_updates(
        {"u": torch.from_numpy(x)}, torch.from_numpy(mask),
        norm_mult=norm_mult)
    assert torch.equal(got[0] + got[1], rejected)
    # the rounds' one pass of the guard's reductions gives both, bitwise
    both = aggregation.sanitize_with_kinds(
        {"u": torch.from_numpy(x)}, torch.from_numpy(mask),
        norm_mult=norm_mult)
    assert torch.equal(both[0]["u"].nan_to_num(), clean["u"].nan_to_num())
    for a, b in zip(both[1:], (cmask, rejected, *got)):
        assert torch.equal(a, b)


# --------------------------------------------------- sync against JAX ----

def _obs(row):
    return {k: v for k, v in row.items() if k.startswith("obs/")}


def _compare_obs(got, want, what):
    assert set(got) == set(want), what
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if k[4:] in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{k}, {what}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k}, {what}")


def _host_row(metrics):
    return {k: v.detach().numpy() for k, v in metrics.items()}


def test_sync_obs_values_match_jax_python_run():
    rounds, k = 4, SYNC["n_clients"]
    jmodel = jbuild(ARCHS["paper-mlp"])
    fed, _ = jbuild_federation(0, kind="tabular", n=240, n_clients=k,
                               batch_size=8, n_classes=10)
    batches = []

    def data_fn(t, rng):
        b = fed.data_fn(t, rng)
        batches.append(jax.tree_util.tree_map(np.asarray, b))
        return b

    rng = jax.random.PRNGKey(0)
    init = jmodel.init(jax.random.split(rng)[0])     # run()'s own r_init
    jcfg = JFedConfig(**SYNC)
    _, hist = jfedfits.run(jmodel, jcfg, data_fn, rounds, rng,
                           driver="python",
                           telemetry=JTelemetry(sinks=[JMemorySink()]))
    cfg = FedConfig(**SYNC)
    state = fedfits.init_state(
        interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, init)),
        k, cfg, torch.Generator().manual_seed(0))
    state = state._replace(tele=counters.init_column("sync", cfg))
    round_fn = fedfits.make_round(build(MLP_CONFIG), cfg)
    total = {}
    for t, (batch, ref) in enumerate(zip(batches, hist), start=1):
        # the availability draw of JAX's python loop, round 1 everyone
        a = np.array(jax.random.uniform(
            jax.random.fold_in(rng, 10_000 + t), (k,)) < cfg.avail_prob,
            np.float32)
        a[0] = 1.0
        batch = {kk: torch.from_numpy(np.array(v)) for kk, v in batch.items()}
        batch["avail"] = torch.from_numpy(a if t > 1 else np.ones(k,
                                                                  np.float32))
        state, m = round_fn(state, batch)
        np.testing.assert_array_equal(m["team"].numpy(), ref["team"])
        _compare_obs(_obs(_host_row(m)), _obs(ref), f"round {t}")
        for name, v in counters.row_obs(_host_row(m)).items():
            total[name] = total.get(name, 0.0) + v
    # the column: counters hold the run's sums, gauges the last round's
    for name, spec in counters.specs_for("sync").items():
        want = total[name] if spec.kind == counters.KIND_COUNTER \
            else counters.row_obs(_host_row(m))[name]
        np.testing.assert_allclose(state.tele[name].numpy(), want,
                                   rtol=1e-6, err_msg=name)


# -------------------------------------------------- async against JAX ----

def _jax_async_draws(jcfg, scales, cap, ecap, m, c, bsz):
    """The draws JAX's async round takes from ``state.rng``, as
    ``tests/test_torch_async.py`` derives them."""

    def fn(jstate):
        _, r_sel, _, r_data, _, r_delay = jax.random.split(jstate.rng, 6)
        kb, ke = jax.random.split(jax.random.fold_in(r_data, 3))
        r_u = jax.random.fold_in(r_delay, 11)
        return {"gumbel": jax.random.gumbel(r_sel, (m,), jnp.float32),
                "bi": jax.random.randint(kb, (c, min(bsz, cap)), 0, cap),
                "ei": jax.random.randint(ke, (c, min(32, ecap)), 0, ecap),
                "u_delay": jax.random.uniform(r_u, (c,), minval=1e-7,
                                              maxval=1.0)}

    jfn = jax.jit(fn)

    def call(jstate):
        draws = {k: torch.from_numpy(np.array(v))
                 for k, v in jfn(jstate).items()}
        draws["bi"], draws["ei"] = draws["bi"].long(), draws["ei"].long()
        return draws

    return call


def _reconcile(hist, c):
    """``tests/test_obs.py::test_async_counters_match_buffer_outcomes``'s
    reconciliations of a history's counters with its own metrics."""
    assert sum(float(h["buffered"]) for h in hist) > 0
    for h in hist:
        assert float(h["obs/buffer/parked"]) == float(h["buffered"])
        assert float(h["obs/buffer/occupancy"]) == float(h["buf_fill"])
        assert (float(h["obs/buffer/exhausted"])
                + float(h["obs/buffer/overflow"]) == float(h["abandoned"]))
        assert (float(h["obs/guard/nonfinite"]) + float(h["obs/guard/norm"])
                == float(h["guard_rejected"]))
        np.testing.assert_allclose(float(h["obs/delivery/on_time"]),
                                   float(h["on_time_frac"]) * c, rtol=1e-6)
        assert np.asarray(h["obs/buffer/age_hist"]).sum() == \
            float(h["buf_fill"])


def test_async_obs_values_match_jax_on_the_parking_setup():
    seed, rounds, m, c = 4, 8, ASYNC["population"], ASYNC["n_clients"]
    jmodel = jbuild(ARCHS["paper-mlp"])
    fed, _ = jbuild_federation(seed, kind="tabular", n=360, n_clients=m,
                               batch_size=8, n_classes=10)
    jcfg, jfl = JFedConfig(**ASYNC), jfaults.FaultConfig(**LATE)
    jround = jax.jit(jae.make_async_round(
        jmodel, jcfg, fed.data, batch_size=8, faults=jfl,
        straggler_rows="head"))
    jdraws = _jax_async_draws(
        jcfg, jfaults.delay_scales(jfl, m, rows="head"),
        fed.data["x"].shape[1], fed.data["eval_x"].shape[1], m, c, 8)
    # as run_async(driver="python") starts
    r_init, r_run = jax.random.split(jax.random.PRNGKey(seed))
    jstate = jae.init_async_state(jmodel.init(r_init), jcfg, r_run)
    jstate = jstate._replace(tele=jcounters.init_column("async", jcfg))
    cfg = FedConfig(**ASYNC)
    pop = {k: torch.from_numpy(np.array(v)) for k, v in fed.data.items()}
    _, round_fn = async_engine.make_async_round(
        build(MLP_CONFIG), cfg, pop, batch_size=8, faults=FaultConfig(**LATE),
        straggler_rows="head")
    state = async_engine.init_async_state(
        interop.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jstate.params)),
        cfg, torch.Generator())
    state = state._replace(tele=counters.init_column("async", cfg))
    hist = []
    for t in range(1, rounds + 1):
        draws = jdraws(jstate)
        jstate, jm = jround(jstate, {})
        state, mets = round_fn(state, draws)
        row = _host_row(mets)
        _compare_obs(_obs(row), _obs(jax.device_get(jm)), f"round {t}")
        hist.append(row)
    _reconcile(hist, c)
    for name in counters.specs_for("async"):
        np.testing.assert_allclose(state.tele[name].numpy(),
                                   np.asarray(jstate.tele[name]), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # the port's own run on the same setup: its draws, its reconciliations
    port_fed, _ = build_federation(seed, kind="tabular", n=360, n_clients=m,
                                   batch_size=8, n_classes=10, device="cpu")
    _, own = async_engine.run_async(
        build(MLP_CONFIG), cfg, port_fed.data, rounds, seed, batch_size=8,
        device="cpu", faults=FaultConfig(**LATE), straggler_rows="head",
        driver="python", telemetry=Telemetry(sinks=[MemorySink()]))
    _reconcile(own, c)


# ------------------------------------------------------- on/off parity ----

def _sync_case():
    model = build(MLP_CONFIG)
    fed, _ = build_federation(0, kind="tabular", n=240, n_clients=6,
                              batch_size=8, n_classes=10, device="cpu")
    return lambda **kw: fedfits.run(model, FedConfig(**SYNC), fed.data_fn,
                                    4, 0, device="cpu", chunk_rounds=2, **kw)


def _async_case():
    model = build(MLP_CONFIG)
    fed, _ = build_federation(1, kind="tabular", n=360, n_clients=12,
                              batch_size=8, n_classes=10, device="cpu")
    return lambda **kw: async_engine.run_async(
        model, FedConfig(**ASYNC), fed.data, 4, 1, batch_size=8,
        device="cpu", faults=FaultConfig(**LATE), straggler_rows="head",
        chunk_rounds=2, **kw)


def _state_tensors(state):
    """Every tensor of a round state but the telemetry column; the async
    buffer's drop row (the dropped parks, written in no set order and
    never read) aside."""
    out = []
    for name in state._fields:
        if name == "tele":
            continue
        v = getattr(state, name)
        if name == "buf":
            v = v._replace(rows=v.rows[:-1])
        out += [x for x in tree.leaves(v) if isinstance(x, torch.Tensor)]
    return out


@pytest.mark.parametrize("driver_name", ["python", "scan"])
@pytest.mark.parametrize("engine", ["sync", "async"])
def test_telemetry_on_off_bitwise(engine, driver_name):
    run = _sync_case() if engine == "sync" else _async_case()
    st_off, h_off = run(driver=driver_name)
    st_on, h_on = run(driver=driver_name,
                      telemetry=Telemetry(sinks=[MemorySink()]))
    assert st_off.tele is None and st_on.tele is not None
    for a, b in zip(_state_tensors(st_off), _state_tensors(st_on)):
        assert torch.equal(a, b)
    assert torch.equal(st_off.rng.get_state(), st_on.rng.get_state())
    assert len(h_on) == len(h_off)
    for r_on, r_off in zip(h_on, h_off):
        assert set(r_off) < set(r_on)
        assert sorted(k for k in r_on if k not in r_off) == sorted(
            "obs/" + n for n in counters.specs_for(engine))
        for k, v in r_off.items():
            if k not in ("wall_ms", "chunk_ms"):
                np.testing.assert_array_equal(np.asarray(r_on[k]),
                                              np.asarray(v), err_msg=k)
    if engine == "async":
        assert sum(float(r["obs/buffer/parked"]) for r in h_on) > 0


def test_telemetry_rows_equal_under_both_drivers():
    """scan == python with the counter column on, every obs/ value too."""
    run = _async_case()
    st_p, h_p = run(driver="python", telemetry=Telemetry())
    st_s, h_s = run(driver="scan", telemetry=Telemetry())
    for rp, rs in zip(h_p, h_s):
        for k in rp:
            if k not in ("wall_ms", "chunk_ms"):
                np.testing.assert_array_equal(np.asarray(rp[k]),
                                              np.asarray(rs[k]), err_msg=k)
    for name in st_p.tele:
        assert torch.equal(st_p.tele[name], st_s.tele[name]), name


# -------------------------------------------------------- run_scenario ----

def test_run_scenario_default_summary_keys_match_jax():
    kw = dict(n_clients=6, n_rounds=2, n=400)
    summary, hist = run_scenario("clean_trimmed", device="cpu", **kw)
    jsummary, jhist = jscenarios.run_scenario("clean_trimmed", **kw)
    assert set(summary) == set(jsummary)
    for k in ("obs_rows", "obs_warnings", "obs_warning_counts"):
        assert summary[k] == jsummary[k], k
    assert sorted(k for k in hist[0] if k.startswith("obs/")) == \
        sorted(k for k in jhist[0] if k.startswith("obs/"))


# ---------------------------------------------------------- artifacts ----

def _checks(paths, engine):
    """Both packages' schema checks on the artifacts, as ``python -m
    repro.obs.check`` and ``python -m repro_torch.obs.check`` run them
    (their ``main``): (exit code, findings) of each."""
    out = []
    for main in (jcheck.main, check.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--require-obs", "--min-phases", "5", "--engine",
                       engine, *paths])
        out.append((rc, [l for l in buf.getvalue().splitlines()
                         if not l.startswith("ok:")]))
    return out


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_artifacts_pass_both_checks(engine, tmp_path):
    run = _sync_case() if engine == "sync" else _async_case()
    jsonl, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    tele = Telemetry(sinks=[JsonlSink(jsonl)], trace_path=trace)
    run(driver="scan", telemetry=tele)
    assert tele.finish()["rows"] == 4
    names = {e["name"] for e in json.load(open(trace))["traceEvents"]}
    assert {"stage", "compute", "drain", "chunk"} | set(PHASE_NAMES) <= names
    assert _checks(["--jsonl", jsonl, "--trace", trace], engine) == \
        [(0, []), (0, [])]
    bad = str(tmp_path / "bad.jsonl")          # no summary record
    with open(jsonl) as f, open(bad, "w") as g:
        g.writelines(l for l in f if json.loads(l)["kind"] != "summary")
    found = _checks(["--jsonl", bad], engine)
    assert found[0] == found[1] and found[0][0] == 1


def test_python_driver_trace_has_measured_rounds(tmp_path):
    trace = str(tmp_path / "t.json")
    tele = Telemetry(trace_path=trace)
    _sync_case()(driver="python", telemetry=tele)
    tele.finish()
    evs = json.load(open(trace))["traceEvents"]
    rounds = [e for e in evs if e["name"] == "round"]
    assert [e["args"]["round"] for e in rounds] == [1, 2, 3, 4]
    assert not any(e["args"].get("attributed") for e in rounds)
    assert not check_trace(trace, min_phases=5)


def test_scan_driver_spans_and_rows_on_a_toy_body():
    """``ScanDriver.run`` and ``run_chunked`` take a Telemetry: every row
    reaches the sinks, each chunk gets its measured spans."""
    body = lambda st, xs: ({"n": st["n"] + 1}, {"n": st["n"] + 1.0})
    for runner in ("driver", "chunked"):
        sink = MemorySink()
        tele = Telemetry(sinks=[sink], trace_path="trace.json")  # not saved
        args = (body, {"n": torch.zeros(())}, lambda t: {}, 5)
        if runner == "driver":
            _, hist = driver.ScanDriver(body, chunk_steps=2).run(
                *args[1:], telemetry=tele)
        else:
            _, hist = driver.run_chunked(*args, chunk_steps=2, telemetry=tele)
        assert [r["n"] for r in sink.by_kind("metrics")] == [1, 2, 3, 4, 5]
        spans = [e["name"] for e in tele.tracer.events
                 if e["tid"] == TraceRecorder.DRIVER_TID]
        for name in ("stage", "compute", "drain", "chunk"):
            assert spans.count(name) == 3, (name, spans)


# --------------------------------------------- monitors, sinks, trace ----

def test_monitor_k_consecutive_streaks():
    m = Monitor("hot", lambda r: r.get("x"), ">", 0.5, k_consecutive=2)
    fires = [m.observe({"x": v, "round": i}) is not None
             for i, v in enumerate([0.6, 0.4, 0.6, 0.7, 0.7])]
    assert fires == [False, False, False, True, True]
    assert m.observe({"y": 1}) is None


def test_monitor_bank_guard_majority_warning():
    bank = MonitorBank()
    row = {"round": 1, "obs/guard/nonfinite": 3.0, "obs/guard/norm": 0.0,
           "obs/select/team_size": 4.0, "obs/gate/cosine_rejected": 0.0,
           "obs/cohort/trust_q": [0.4, 0.5, 0.6]}
    assert bank.observe(row) == []
    fired = bank.observe({**row, "round": 2})
    assert [w["monitor"] for w in fired] == ["guard_rejecting_majority"]
    assert fired[0]["round"] == 2 and fired[0]["streak"] == 2
    assert bank.counts() == {"guard_rejecting_majority": 1}


def test_jsonable_coerces_tensors_and_numpy():
    assert jsonable(torch.tensor(3.0)) == 3
    assert jsonable(torch.tensor(3.5)) == 3.5
    assert jsonable(np.float64(2 ** 60)) == float(2 ** 60)
    assert jsonable(torch.arange(3.0)) == [0, 1, 2]
    assert jsonable(torch.tensor([1.5], dtype=torch.bfloat16)) == [1.5]
    assert jsonable({"a": (torch.tensor(1, dtype=torch.int32), None)}) == \
        {"a": [1, None]}


def test_jsonl_sink_roundtrip_and_close(tmp_path):
    path = str(tmp_path / "m.jsonl")
    s = JsonlSink(path)
    s.emit({"kind": "metrics", "round": 1, "obs/x": torch.tensor(2.0)})
    s.close()
    assert [json.loads(l) for l in open(path)] == \
        [{"kind": "metrics", "round": 1, "obs/x": 2}]
    with pytest.raises(ValueError):
        s.emit({"kind": "metrics"})


def test_multi_and_memory_sinks_fan_out():
    a, b = MemorySink(), MemorySink(capacity=1)
    multi = MultiSink([a, b])
    multi.emit({"kind": "metrics", "round": 1})
    multi.emit({"kind": "warning", "monitor": "m"})
    assert len(a.records) == 2 and len(b.records) == 1
    assert a.by_kind("warning") == [{"kind": "warning", "monitor": "m"}]


def test_trace_recorder_emits_checkable_phase_spans(tmp_path):
    rec = TraceRecorder("sync")
    rec.begin("stage")
    rec.end("stage", steps=2)
    rows = [{"round": t, "obs/gate/cosine_rejected": 0.0,
             "obs/select/team_size": 4.0,
             "obs/cohort/trust_q": np.array([0.1, 0.5, 0.9], np.float32)}
            for t in (1, 2)]
    rec.emit_rounds(0.0, 1000.0, rows)
    trace = rec.to_json()
    assert set(PHASE_NAMES) <= {e["name"] for e in trace["traceEvents"]}
    assert not check_trace(trace, min_phases=5)
    path = tmp_path / "t.json"
    rec.save(str(path))
    assert not check_trace(str(path), min_phases=5)
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["name"] not in PHASE_NAMES]
    assert check_trace(trace, min_phases=5)
