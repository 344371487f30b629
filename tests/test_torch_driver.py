"""The port's chunked round driver (``repro_torch/core/driver.py``) on the
CPU, where the chunk loop runs eagerly (on the card it replays a CUDA
graph; ``tests/test_torch_cuda.py`` holds that against the eager loop).

  * ``ScanDriver`` on a toy body: chunk edges (1, chunk, chunk + 1 and
    2 chunk + 3 steps), ``t0``, ``index_key``, ``on_chunk`` once a chunk
    and ``batch_fn`` once a step in ascending order, against a plain
    loop over the same body;
  * ``copy_into``, the static-state copy a captured step ends with, and
    the launch counters a replay advances (``kernels/launches.py``);
  * ``fedfits.run(driver="scan")`` bitwise ``driver="python"`` over 7
    rounds at ``chunk_rounds`` 1, 3 and 8 (partial chunks), with
    availability draws, int8 with error feedback, stragglers with dropout
    and partial work, a noisy update attack and the stateful
    ``CrossRoundGateAware``; ``run_async`` and ``run_scenario`` (one sync
    and one async cell) the same;
  * the port's scan run against the JAX package's ``driver="python"``
    run, on the JAX init and batches: teams and h exact, params within
    atol 1e-5, the tolerance of ``tests/test_torch_slice.py`` (conv,
    matmul and the aggregation sums run in other orders).  JAX's own scan
    is not bitwise its python loop on this jax install (ROADMAP queue 3).

Bitwise: every history value has the same dtype, shape and bytes, and
every state tensor is equal (but the async buffer's drop row, which is
never read).
"""
import dataclasses

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
from repro_torch.configs.paper_models import CNN_CONFIG, MLP_CONFIG
from repro_torch.configs.registry import get_config
from repro_torch.core import async_engine, attacks, driver, fedfits
from repro_torch.core.faults import FaultConfig
from repro_torch.data.pipeline import build_federation
from repro_torch.kernels import launches
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.launch.serve import draw_requests
from repro_torch.models.model import build
from repro_torch.scenarios import run_scenario
from repro_torch.serve import ServeConfig, ServeEngine

K, ROUNDS, ATOL = 6, 7, 1e-5
CHUNK = 3
HOST_KEYS = ("wall_ms", "chunk_ms")           # host clocks, not results


# ------------------------------------------------------------ toy body --
def _toy_body(st, xs):
    t, batch = xs
    acc = st["acc"] + batch["x"].sum() * t.float()
    new = {"acc": acc, "n": st["n"] + 1}
    return new, {"t": t, "x": batch["x"], "acc": acc, "late": t > 2}


def _toy_batch(calls):
    def batch_fn(t):
        calls.append(t)
        return {"x": torch.arange(3, dtype=torch.float32) + t}
    return batch_fn


@pytest.mark.parametrize("n_steps,t0", [(1, 0), (CHUNK, 0), (CHUNK + 1, 5),
                                        (2 * CHUNK + 3, 1)])
def test_scan_driver_chunk_edges(n_steps, t0):
    calls, chunks = [], []
    state = {"acc": torch.zeros(()), "n": torch.zeros((), dtype=torch.int32)}
    drv = driver.ScanDriver(_toy_body, chunk_steps=CHUNK)
    final, hist = drv.run(state, _toy_batch(calls), n_steps, t0=t0,
                          index_key="round",
                          on_chunk=lambda st, rows: chunks.append(
                              (float(st["acc"]), [r["round"] for r in rows])))
    ts = list(range(t0, t0 + n_steps))
    assert calls == ts                            # once a step, ascending
    assert [r["round"] for r in hist] == ts
    assert [c[1] for c in chunks] == [ts[i:i + CHUNK]
                                      for i in range(0, n_steps, CHUNK)]
    # the plain loop over the same body
    ref, rows = dict(state), []
    for t in ts:
        ref, m = _toy_body(ref, (torch.tensor(t, dtype=torch.int32),
                                 _toy_batch([])(t)))
        rows.append(m)
    assert torch.equal(final["acc"], ref["acc"])
    assert int(final["n"]) == n_steps
    assert chunks[-1][0] == float(ref["acc"])     # on_chunk sees the state
    for row, m in zip(hist, rows):
        for k, v in m.items():
            np.testing.assert_array_equal(row[k], v.numpy())
            assert row[k].dtype == v.numpy().dtype, k
        assert row["chunk_ms"] >= row["wall_ms"] > 0
    assert drv.captures == drv.replays == 0       # no graph on the CPU


def test_scan_driver_refuses_host_metrics_and_empty_runs():
    drv = driver.ScanDriver(lambda st, xs: (st, {"v": 1.0}))
    state = {"w": torch.zeros(2)}
    with pytest.raises(TypeError, match="not a tensor"):
        drv.run(state, lambda t: {}, 2)
    assert drv.run(state, lambda t: {}, 0) == (state, [])


def test_stage_chunk_stacks_in_order():
    calls = []
    ts_dev, stacked = driver.stage_chunk(_toy_batch(calls), [4, 5, 6])
    assert calls == [4, 5, 6]
    assert ts_dev.dtype == torch.int32 and ts_dev.tolist() == [4, 5, 6]
    assert torch.equal(stacked["x"], torch.stack(
        [torch.arange(3.0) + t for t in (4, 5, 6)]))
    ts_dev, stacked = driver.stage_chunk(lambda t: {}, [1, 2])
    assert stacked == {} and ts_dev.tolist() == [1, 2]


def test_copy_into_carries_tensors_in_place():
    gen = torch.Generator()
    zero = torch.zeros(())
    static = fedfits.FedState(
        params={"w": torch.zeros(3)}, team=torch.ones(2),
        alpha=torch.ones(()), slot=None, h=torch.tensor(True), rng=gen,
        round=torch.ones((), dtype=torch.int32), cost_client_rounds=zero,
        cost_bytes_up=zero.clone(), cost_bytes_down=zero.clone(),
        clients=None)
    w, team = static.params["w"], static.team
    # the new team is a view of the old params, which the copy writes
    # first: it must keep the old values (0), not the new params' (2)
    new = static._replace(params={"w": torch.full((3,), 2.0)},
                          team=w[1:], round=static.round + 1,
                          h=static.team[0] > 0)
    driver.copy_into(static, new)
    assert static.params["w"] is w and static.team is team   # in place
    assert w.tolist() == [2.0, 2.0, 2.0] and team.tolist() == [0.0, 0.0]
    assert int(static.round) == 2
    with pytest.raises(ValueError, match="not a tensor"):
        driver.copy_into(static, static._replace(rng=torch.Generator()))
    with pytest.raises(ValueError, match="changed from"):
        driver.copy_into(static, static._replace(team=torch.ones(3)))


def test_launch_counters_advance_by_a_recording():
    before = launches.snapshot()
    rp.gated_combine.launches["mean"] += 2
    rp.pairwise_gram.launches += 1
    rec = launches.since(before)
    assert {(f.__name__, m): n for (f, m), n in rec.items()} == {
        ("gated_combine", "mean"): 2, ("pairwise_gram", None): 1}
    launches.restore(before)
    assert launches.since(before) == {}
    launches.add(rec, times=3)
    assert rp.gated_combine.launches["mean"] == before[
        (rp.gated_combine, "mean")] + 6
    launches.restore(before)


# ------------------------------------------------------ the sync engine --
def _gauss(upd, mal, noise):
    return attacks.gaussian_update(upd, mal, 0.05, noise)


_gauss.draws_noise = True
_MAL = torch.tensor([1.0, 1.0] + [0.0] * (K - 2))
_FAULTS = FaultConfig(straggler_frac=0.25, straggler_delay=3.0,
                      base_delay=0.3, dropout_prob=0.3, partial_min_frac=0.3)
_SYNC = {
    "avail": (dict(avail_prob=0.7, explore_eps=0.3), {}),
    "int8_ef": (dict(compress="int8", error_feedback=True,
                     aggregator="trimmed_mean"), {}),
    "faults": (dict(aggregator="krum"), dict(faults=_FAULTS)),
    "noisy_attack": (dict(aggregator="trimmed_mean"),
                     dict(update_attack=_gauss, malicious=_MAL)),
    "cross_round": (dict(aggregator="trimmed_mean"), dict(
        update_attack="cross_round", malicious=_MAL)),
}


@pytest.fixture(scope="module")
def sync_setup():
    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    fed, test = build_federation(0, kind="images", n=480, n_clients=K,
                                 batch_size=8, eval_batch=8, device="cpu")

    def evaluate(params):
        _, m = model.loss(params, test)
        return {"test_acc": m["acc"]}

    return model, fed, evaluate, {}


def _sync_run(setup, case, drv, chunk=8):
    model, fed, evaluate, _ = setup
    kw, extra = _SYNC[case]
    cfg = FedConfig(n_clients=K, algorithm="fedfits", local_epochs=2,
                    local_lr=0.05, msl=3, pft=2, **kw)
    extra = dict(extra)
    if extra.get("update_attack") == "cross_round":
        extra["update_attack"] = attacks.CrossRoundGateAware(cfg)
    return fedfits.run(model, cfg, fed.data_fn, ROUNDS, 3, eval_fn=evaluate,
                       device="cpu", driver=drv, chunk_rounds=chunk, **extra)


def _bitwise(a, b):
    """Two (state, history) runs bit for bit."""
    (sa, ha), (sb, hb) = a, b
    assert len(ha) == len(hb)
    for ra, rb in zip(ha, hb):
        assert set(ra) - set(HOST_KEYS) <= set(rb)
        for k, v in ra.items():
            if k in HOST_KEYS:
                continue
            x, y = np.asarray(v), np.asarray(rb[k])
            assert (x.dtype, x.shape) == (y.dtype, y.shape), k
            assert x.tobytes() == y.tobytes(), (k, ra["round"])
    la, lb = tree.leaves(sa), tree.leaves(sb)
    assert len(la) == len(lb)
    rows = getattr(getattr(sa, "buf", None), "rows", None)
    for x, y in zip(la, lb):
        if rows is not None and x is rows:
            # the async buffer's drop row takes the dropped parks by an
            # index_copy_ with duplicate indices, in no set order even on
            # the CPU's threads; it is never read
            x, y = x[:-1], y[:-1]
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(_SYNC))
def test_fedfits_scan_matches_python_bitwise(sync_setup, case, chunk):
    refs = sync_setup[3]
    if case not in refs:
        refs[case] = _sync_run(sync_setup, case, "python")
    out = _sync_run(sync_setup, case, "scan", chunk)
    _bitwise(out, refs[case])
    assert [r["round"] for r in out[1]] == list(range(1, ROUNDS + 1))


def test_fedfits_scan_draws_every_round(sync_setup):
    """The availability and fault draws differ from round to round (a
    generator that repeated its draws would repeat the masks)."""
    _, hist = _sync_run(sync_setup, "avail", "scan", CHUNK)
    avail = {r["avail"].tobytes() for r in hist[1:]}
    assert len(avail) > 1
    _, hist = _sync_run(sync_setup, "faults", "scan", CHUNK)
    assert len({r["lost"].tobytes() + r["eff_epochs"].tobytes()
                for r in hist}) > 1


# ----------------------------------------------------- the async engine --
@pytest.mark.parametrize("chunk", [1, 4])
def test_run_async_scan_matches_python_bitwise(chunk):
    model = build(MLP_CONFIG)
    fed, test = build_federation(0, kind="tabular", n=600, n_clients=24,
                                 batch_size=8, eval_batch=8, device="cpu")
    cfg = FedConfig(n_clients=4, population=24, local_epochs=2,
                    local_lr=0.05, aggregator="trimmed_mean",
                    async_max_retries=2, select_method="pallas")
    late = FaultConfig(straggler_frac=0.3, straggler_delay=3.0,
                       base_delay=0.3)

    def evaluate(params):
        _, m = model.loss(params, test)
        return {"test_acc": m["acc"]}

    runs = [async_engine.run_async(
        model, cfg, fed.data, 6, 2, eval_fn=evaluate, batch_size=8,
        eval_batch=8, device="cpu", faults=late, driver=drv,
        chunk_rounds=chunk) for drv in ("python", "scan")]
    _bitwise(runs[1], runs[0])
    assert sum(float(r["buffered"]) for r in runs[1][1]) > 0


@pytest.mark.parametrize("cell", ["hetero_fedfits+gaussian",
                                  "async_late_poison"])
def test_run_scenario_scan_matches_python_bitwise(cell):
    from repro_torch.scenarios import registry
    base, _, attack = cell.partition("+")
    sc = registry.get(base)
    if attack:
        sc = sc.replace(attack=attack, attack_scale=0.05)
    kw = dict(n_clients=K, n_rounds=5, n=480, device="cpu")
    (s_py, h_py), (s_sc, h_sc) = [
        run_scenario(sc, driver=drv, chunk_rounds=2, **kw)
        for drv in ("python", "scan")]
    _bitwise((torch.zeros(()), h_sc), (torch.zeros(()), h_py))
    for k, v in s_py.items():
        if k != "wall_s":
            assert s_sc[k] == v, k


# --------------------------------------------------- against the JAX run --
@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
def test_scan_run_matches_jax_python_driver(aggregator):
    jmodel = jbuild(JCNN.replace(d_model=4, d_ff=16))
    jfed, _ = jbuild_federation(0, kind="images", n=600, n_clients=K,
                                batch_size=16, eval_batch=16)
    batches = []

    def jdata_fn(t, rng):
        b = jfed.data_fn(t, rng)
        batches.append(jax.tree_util.tree_map(np.asarray, b))
        return b

    def jeval(params):
        return {f"p{i}": l for i, l in
                enumerate(jax.tree_util.tree_leaves(params))}

    rng = jax.random.PRNGKey(0)
    init = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.split(rng)[0]))
    fed_kw = dict(n_clients=K, algorithm="fedfits", local_epochs=2,
                  local_lr=0.05, msl=4, pft=2, aggregator=aggregator)
    _, jhist = jfedfits.run(jmodel, JFedConfig(**fed_kw), jdata_fn, 4, rng,
                            eval_fn=jeval, driver="python")

    model = build(CNN_CONFIG.replace(d_model=4, d_ff=16))
    model = dataclasses.replace(
        model, init=lambda gen: interop.params_from_numpy(init))

    def data_fn(t, gen):
        return {k: torch.from_numpy(np.array(v))
                for k, v in batches[t - 1].items()}

    def evaluate(params):
        return {f"p{i}": l for i, l in enumerate(tree.leaves(params))}

    _, hist = fedfits.run(model, FedConfig(**fed_kw), data_fn, 4, 0,
                          eval_fn=evaluate, device="cpu", driver="scan",
                          chunk_rounds=3)
    for t, (row, ref) in enumerate(zip(hist, jhist), start=1):
        np.testing.assert_array_equal(row["team"], ref["team"],
                                      err_msg=f"team, round {t}")
        assert bool(row["h_next"]) == bool(ref["h_next"]), t
        np.testing.assert_allclose(row["score"], ref["score"], atol=ATOL)
        for i in range(len(tree.leaves(init))):
            np.testing.assert_allclose(row[f"p{i}"], ref[f"p{i}"],
                                       atol=ATOL,
                                       err_msg=f"leaf {i}, round {t}")


# ---------------------------------------------------------- the server --
def test_serve_engine_reuses_and_resets_its_state():
    """``run`` drives the engine's own pools and slots, reset between runs:
    a second run on the same engine gives the first run's tokens, on the
    same tensors."""
    cfg = get_config("tiny-lm").reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0))
    engine = ServeEngine(cfg, ServeConfig(max_slots=3, page_size=4,
                                          max_len=32, prompt_pad=8,
                                          temperature=0.7), params, seed=1,
                         device="cpu")
    reqs = draw_requests(5, 6, 2, 12, cfg.vocab_size, seed=2)
    first, s1 = engine.run(reqs)
    pools = [t for t in tree.leaves(engine._static[0])]
    again, s2 = engine.run(reqs)
    assert again == first and s2["steps"] == s1["steps"]
    assert all(a is b for a, b in zip(pools,
                                      tree.leaves(engine._static[0])))
