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

The cases are spread over nine files of about equal time, so that the
suite's workers take them in parallel: this one (the toy body, the
server, the draws from round to round), one file a sync case
(``test_torch_driver_{avail,cross_round,faults,int8,attack}.py``),
``test_torch_driver_async.py`` (``run_async``),
``test_torch_driver_scenario.py`` (``run_scenario``) and
``test_torch_driver_jax.py`` (the JAX run); the sync cases and their
comparison live in ``torch_driver_cases.py``.

Bitwise: every history value has the same dtype, shape and bytes, and
every state tensor is equal (but the async buffer's drop row, which is
never read).
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.core import driver, fedfits
from repro_torch.kernels import launches
from repro_torch.kernels import robust_pipeline as rp
from repro_torch.launch.serve import draw_requests
from repro_torch.models.model import build
from repro_torch.serve import ServeConfig, ServeEngine
from torch_driver_cases import (  # noqa: F401
    CHUNK, _sync_run, one_thread, sync_setup)


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
def test_fedfits_scan_draws_every_round(sync_setup):
    """The availability and fault draws differ from round to round (a
    generator that repeated its draws would repeat the masks)."""
    _, hist = _sync_run(sync_setup, "avail", "scan", CHUNK)
    avail = {r["avail"].tobytes() for r in hist[1:]}
    assert len(avail) > 1
    _, hist = _sync_run(sync_setup, "faults", "scan", CHUNK)
    assert len({r["lost"].tobytes() + r["eff_epochs"].tobytes()
                for r in hist}) > 1


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
