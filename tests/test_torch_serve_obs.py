"""The serving engine's telemetry and its admission with device scalars,
against the JAX package's engine (``repro/serve``) at ``tiny-lm.reduced()``
on JAX's params (through ``interop``), on the CPU.

  * The admission takes its request from the engine's static buffer,
    ``plen``, ``max_new`` and ``req_id`` as 0-d device tensors: request by
    request, its first token, ``ok``, slot and the whole ``SlotState``
    (the ``tele`` counter column included) are JAX's ``_admit``'s, and so
    are the decode steps that follow.
  * Both steps publish every ``serve/*`` signal of the registry, so the
    column covers the registry's slice.
  * ``run(telemetry=...)`` is bit for bit the run without it (tokens,
    stats, the final ``SlotState``), its rows reconcile with the run's
    stats, and its JSONL and trace pass both packages' schema checks.
  * On the CPU both steps stay eager: no graph is captured.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch.serve import draw_requests as jdraw_requests
from repro.models.model import build as jbuild
from repro.obs import check as jcheck
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.obs import JsonlSink, MemorySink, Telemetry, check, counters
from repro_torch.serve import Request, ServeConfig, ServeEngine

SCFG = dict(max_slots=4, page_size=8, max_len=48, prompt_pad=8)
FIELDS = ("tok", "length", "budget", "active", "req_id", "alloc", "table",
          "free")


@pytest.fixture(scope="module")
def tiny():
    jc = jget_config("tiny-lm").reduced()
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jc, get_config("tiny-lm").reduced(), jp, tp


def _same_state(st, jst, what):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{f}, {what}")
    assert sorted(st.tele) == sorted(jst.tele)
    for k, v in st.tele.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jst.tele[k]),
                                      err_msg=f"tele {k}, {what}")


@pytest.mark.parametrize("attn", ["ref", "pallas"])
def test_admission_with_device_scalars_matches_jax(tiny, attn):
    jc, tc, jp, tp = tiny
    kw = dict(SCFG, attn=attn)
    jeng = JServeEngine(jc, JServeConfig(**kw), jp, seed=0)
    eng = ServeEngine(tc, ServeConfig(**kw), tp, seed=0, device="cpu")
    jcache, jst = jeng.fresh_state()
    cache, st = eng._reset()
    reqs = jdraw_requests(6, 6, 1, 12, jc.vocab_size, seed=4)
    for i, r in enumerate(reqs):
        prompt = np.zeros(SCFG["prompt_pad"], np.int32)
        prompt[:len(r.tokens)] = r.tokens
        jcache, jst, jout = jeng._admit(jp, jcache, jst, jnp.asarray(prompt),
                                        jnp.int32(len(r.tokens)),
                                        jnp.int32(r.max_new),
                                        jnp.int32(r.req_id))
        out = eng._admission(cache, st, Request(r.req_id, r.tokens,
                                                r.max_new))
        assert eng._req[-3:].dtype == torch.int64   # the device scalars
        assert (out["ok"], out["slot"], out["tok0"]) == (
            bool(jout["ok"]), int(jout["slot"]), int(jout["tok0"])), i
        assert out["vals"] == pytest.approx(
            {k: float(v) for k, v in jout["vals"].items()})
        _same_state(st, jst, f"admission {i}")
        if i % 2:                       # a decode step between admissions
            jcache, jst, jdec = jeng._decode(jp, jcache, jst)
            dec = eng._step(cache, st)
            assert dec["next"] == np.asarray(jdec["next"]).tolist()
            _same_state(st, jst, f"decode after admission {i}")
    assert eng._graph is None and eng._admit_graph is None   # CPU: eager


def test_both_steps_cover_the_serve_registry(tiny):
    _, tc, _, tp = tiny
    eng = ServeEngine(tc, ServeConfig(**SCFG), tp, device="cpu")
    cache, st = eng.fresh_state()
    want = set(counters.specs_for("serve"))
    prompt = torch.zeros(SCFG["prompt_pad"], dtype=torch.int64)
    _, st, out = eng._admit(tp, cache, st, prompt, torch.tensor(3),
                            torch.tensor(5), torch.tensor(0))
    assert set(out["vals"]) == want
    _, st, out = eng._decode(tp, cache, st)
    assert set(out["vals"]) == want
    assert float(out["vals"]["serve/admitted"]) == 0.0
    assert float(st.tele["serve/admitted"]) == 1.0
    assert float(st.tele["serve/tokens"]) == 2.0      # tok0, then one step


def _run(tc, tp, temperature, telemetry=None):
    eng = ServeEngine(tc, ServeConfig(**SCFG, temperature=temperature), tp,
                      seed=3, device="cpu")
    reqs = [Request(r.req_id, r.tokens, r.max_new) for r in
            jdraw_requests(9, 6, 1, 20, tc.vocab_size, seed=2)]
    res, stats = eng.run(reqs, telemetry=telemetry)
    return eng, reqs, res, stats


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_serving_telemetry_on_off_bitwise(tiny, temperature):
    _, tc, _, tp = tiny
    e_off, _, res_off, s_off = _run(tc, tp, temperature)
    sink = MemorySink()
    e_on, reqs, res_on, s_on = _run(tc, tp, temperature,
                                    Telemetry(sinks=[sink]))
    assert res_on == res_off
    for k in ("steps", "tokens", "occupancy_trail", "free_pages_end"):
        assert s_on[k] == s_off[k], k
    (_, a), (_, b) = e_off._static, e_on._static
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for k in a.tele:
        assert torch.equal(a.tele[k], b.tele[k]), k
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    rows = sink.by_kind("metrics")
    assert [r["round"] for r in rows] == list(range(1, s_on["steps"] + 1))
    # admissions after the last decode step reach no row
    assert 0 < sum(r["obs/serve/admitted"] for r in rows) <= len(reqs)
    assert sum(r["obs/serve/tokens"] for r in rows) + len(reqs) == \
        s_on["tokens"]
    assert [int(r["obs/serve/slot_occupancy"]) for r in rows] == \
        s_on["occupancy_trail"]
    # the column holds the run's totals: every admission, every token
    assert float(b.tele["serve/admitted"]) == len(reqs)
    assert float(b.tele["serve/tokens"]) == s_on["tokens"]


def test_serve_artifacts_pass_both_checks(tiny, tmp_path):
    _, tc, _, tp = tiny
    jsonl, trace = str(tmp_path / "s.jsonl"), str(tmp_path / "s.json")
    tele = Telemetry(sinks=[JsonlSink(jsonl)], trace_path=trace,
                     run_name="serve")
    _, _, _, stats = _run(tc, tp, 0.0, tele)
    assert tele.finish()["rows"] == stats["steps"]
    evs = json.load(open(trace))["traceEvents"]
    assert sum(e["name"] == "round" for e in evs) == stats["steps"]
    assert any(e["ph"] == "C" and e["name"] == "serve/slot_occupancy"
               for e in evs)
    for main in (jcheck.main, check.main):      # as python -m ... runs them
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--require-obs", "--min-phases", "5", "--engine",
                       "serve", "--jsonl", jsonl, "--trace", trace])
        assert rc == 0 and buf.getvalue().startswith("ok:"), buf.getvalue()
