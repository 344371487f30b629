"""The port's serving stack against the JAX package (``repro/serve``,
``repro/launch/serve.py``): the scheduler's functions and ``HostLedger``
exact on the same inputs, ``draw_requests`` identical, and
``ServeEngine.run`` at ``tiny-lm.reduced()`` on JAX's params (through
``interop``) giving JAX's tokens under argmax, with the reference
``"ref"`` attention and with ``"pallas"`` (JAX's paged flash-decode in
interpret mode; the port's K8, plain on the CPU), continuous and fixed,
fp32 and int8 KV.  Then page conservation, ``max_new = 1``, the byte
count, paged against the dense full cache, and sampling fed JAX's Gumbel
draws.

Tolerances: tokens exact (argmax over logits that agree within ~1e-5).
int8: on the same K rows, scales within one fp32 ulp of jitted JAX's (XLA
multiplies by the reciprocal of 127 under jit; the port divides, as eager
JAX does) and codes within one level; in the engines' pools, whose K rows
themselves differ in the last bits, scales within 1e-5 relative and codes
within one level.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch.serve import draw_requests as jdraw_requests
from repro.models.model import build as jbuild
from repro.serve import HostLedger as JHostLedger
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import kv_bytes_read as jkv_bytes_read
from repro.serve import scheduler as jsched
from repro_torch import interop
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.serve import draw_requests, make_decode_step
from repro_torch.models.model import build
from repro_torch.serve import (HostLedger, Request, ServeConfig,
                               ServeEngine, kv_bytes_read)
from repro_torch.serve import engine as serve_engine
from repro_torch.serve import scheduler as sched

SCFG = dict(max_slots=4, page_size=8, max_len=48, prompt_pad=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny CPU models under six test workers: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    jc = jget_config("tiny-lm").reduced()
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jc, get_config("tiny-lm").reduced(), jp, tp


def _as_tuples(reqs):
    return [(r.req_id, r.tokens, r.max_new) for r in reqs]


def _port_reqs(reqs):
    return [Request(r.req_id, r.tokens, r.max_new) for r in reqs]


# -------------------------------------------------------------- scheduler --
@pytest.mark.parametrize("seed", range(4))
def test_pick_free_slot_and_take_pages_match_jax(seed):
    rng = np.random.default_rng(seed)
    active = (rng.random(6) < 0.5).astype(np.float32)
    if seed == 3:
        active[:] = 1.0                                   # no free slot
    slot, ok = sched.pick_free_slot(torch.from_numpy(active))
    jslot, jok = jsched.pick_free_slot(jnp.asarray(active))
    assert (int(slot), bool(ok)) == (int(jslot), bool(jok))
    free = (rng.random(20) < 0.4).astype(np.float32)
    for need in (0, 1, 3, int(free.sum()), int(free.sum()) + 1):
        pages, ok, free2 = sched.take_pages(torch.from_numpy(free),
                                            need, 5)
        jpages, jok, jfree2 = jsched.take_pages(jnp.asarray(free),
                                                jnp.int32(need), 5)
        np.testing.assert_array_equal(pages.numpy(), np.asarray(jpages))
        assert bool(ok) == bool(jok)
        np.testing.assert_array_equal(free2.numpy(), np.asarray(jfree2))


def test_budget_pages_and_validation_match_jax():
    kw = dict(max_slots=2, page_size=4, max_len=16, prompt_pad=8)
    scfg, jscfg = ServeConfig(**kw), JServeConfig(**kw)
    assert (scfg.pages_per_slot, scfg.total_pages) == \
        (jscfg.pages_per_slot, jscfg.total_pages)
    for plen in (1, 5, 8):
        for max_new in (1, 4, 30):
            assert sched.kv_budget(plen, max_new, scfg) == \
                jsched.kv_budget(plen, max_new, jscfg)
            assert sched.pages_needed(plen, max_new, scfg) == \
                jsched.pages_needed(plen, max_new, jscfg)
    for toks, max_new in (((1, 2, 3), 4), ((), 4), (tuple(range(9)), 4),
                          ((1,), 0)):
        ours = theirs = None
        try:
            sched.validate_request(Request(0, toks, max_new), scfg)
        except ValueError as e:
            ours = str(e)
        try:
            jsched.validate_request(jsched.Request(0, toks, max_new), jscfg)
        except ValueError as e:
            theirs = str(e)
        assert ours == theirs


def test_host_ledger_replays_jax():
    kw = dict(max_slots=3, page_size=4, max_len=16, prompt_pad=4)
    led, jled = HostLedger(ServeConfig(**kw)), JHostLedger(JServeConfig(**kw))
    ops = [("admit", 3), ("admit", 4), ("evict", 0), ("admit", 2),
           ("admit", 1), ("evict", 1), ("admit", 5)]
    for op, arg in ops:
        if op == "admit":
            assert led.can_admit(arg) == jled.can_admit(arg)
            if not led.can_admit(arg):
                continue
            assert led.next_slot() == jled.next_slot()
            s = led.next_slot()
            led.admit_at(s, arg)
            jled.admit_at(s, arg)
        else:
            led.evict(arg)
            jled.evict(arg)
        assert (led.free_pages, led.slot_pages, led.active,
                led.n_active) == (jled.free_pages, jled.slot_pages,
                                  jled.active, jled.n_active)
    with pytest.raises(RuntimeError):
        HostLedger(ServeConfig(**kw)).evict(0)


def test_draw_requests_identical():
    for args in ((10, 6, 2, 24, 512, 5), (48, 128, 16, 256, 256000, 0)):
        assert _as_tuples(draw_requests(*args[:5], seed=args[5])) == \
            _as_tuples(jdraw_requests(*args[:5], seed=args[5]))


def test_kv_bytes_read_matches_jax():
    cfg, jcfg = get_config("minitron-4b"), jget_config("minitron-4b")
    for int8 in (False, True):
        kw = dict(page_size=16, kv_int8=int8)
        assert kv_bytes_read(cfg, ServeConfig(**kw), 37.0) == \
            jkv_bytes_read(jcfg, JServeConfig(**kw), 37.0)
    f32 = kv_bytes_read(cfg, ServeConfig(page_size=16), 4.0)
    assert f32 / kv_bytes_read(cfg, ServeConfig(page_size=16, kv_int8=True),
                               4.0) > 3.0


# ----------------------------------------------------------------- engine --
@pytest.fixture(scope="module")
def jax_runs(tiny):
    """JAX's tokens for the engine cells, one jitted engine a config."""
    jc, _, jp, _ = tiny
    reqs = jdraw_requests(10, 6, 2, 24, jc.vocab_size, seed=5)
    out = {}
    for attn in ("ref", "pallas"):
        eng = JServeEngine(jc, JServeConfig(**SCFG, attn=attn), jp, seed=2)
        for continuous in (True, False):
            out[attn, continuous] = eng.run(reqs, continuous=continuous)
    return reqs, out


@pytest.mark.parametrize("attn", ["ref", "pallas"])
@pytest.mark.parametrize("continuous", [True, False])
def test_engine_tokens_match_jax(tiny, jax_runs, attn, continuous):
    _, tc, _, tp = tiny
    reqs, runs = jax_runs
    engine = ServeEngine(tc, ServeConfig(**SCFG, attn=attn), tp, seed=2,
                         device="cpu")
    results, stats = engine.run(_port_reqs(reqs), continuous=continuous)
    jresults, jstats = runs[attn, continuous]
    assert results == jresults
    for k in ("steps", "tokens", "occupancy_trail", "free_pages_end"):
        assert stats[k] == jstats[k], k
    assert stats["free_pages_end"] == engine.scfg.total_pages
    for r in reqs:
        assert len(results[r.req_id]) == r.max_new


def _drive(engine, reqs, steps, admit, to_host):
    """Admit ``reqs`` into a fresh state, then ``steps`` decode steps;
    returns the pools."""
    cache, st = engine.fresh_state()
    for r in reqs:
        prompt = np.zeros(engine.scfg.prompt_pad, np.int32)
        prompt[:len(r.tokens)] = r.tokens
        cache, st, out = admit(engine, cache, st, prompt, r)
        assert to_host(out["ok"])
    for _ in range(steps):
        cache, st, _ = engine._decode(engine.params, cache, st)
    return cache


def test_int8_engine_matches_jitted_jax(tiny):
    jc, tc, jp, tp = tiny
    reqs = jdraw_requests(4, 6, 2, 10, jc.vocab_size, seed=1)
    kw = dict(SCFG, kv_int8=True, attn="pallas")
    jeng = JServeEngine(jc, JServeConfig(**kw), jp, seed=0)
    eng = ServeEngine(tc, ServeConfig(**kw), tp, seed=0, device="cpu")
    jres, _ = jeng.run(reqs)
    res, stats = eng.run(_port_reqs(reqs))
    assert res == jres
    assert stats["free_pages_end"] == eng.scfg.total_pages
    jpools = _drive(
        jeng, reqs, 3,
        lambda e, c, s, p, r: e._admit(e.params, c, s, jnp.asarray(p),
                                       jnp.int32(len(r.tokens)),
                                       jnp.int32(r.max_new),
                                       jnp.int32(r.req_id)), bool)
    pools = _drive(
        eng, _port_reqs(reqs), 3,
        lambda e, c, s, p, r: e._admit(e.params, c, s,
                                       torch.from_numpy(p).long(),
                                       len(r.tokens), r.max_new, r.req_id),
        bool)
    for k in ("ks", "vs"):
        np.testing.assert_allclose(pools["b0"][k][:, :-1].numpy(),
                                   np.asarray(jpools["b0"][k]), rtol=1e-5)
    for k in ("kp", "vp"):
        diff = (pools["b0"][k][:, :-1].numpy().astype(int)
                - np.asarray(jpools["b0"][k]).astype(int))
        assert np.abs(diff).max() <= 1, k


def test_decode_step_from_jax_state_matches_jax(tiny):
    """One decode step of the port's engine from JAX's admitted state (its
    pools and SlotState through ``interop``): JAX's tokens and slot state,
    its pools within ATOL (the appended K/V rows round differently)."""
    jc, tc, jp, tp = tiny
    kw = dict(SCFG, attn="pallas")
    jeng = JServeEngine(jc, JServeConfig(**kw), jp, seed=0)
    eng = ServeEngine(tc, ServeConfig(**kw), tp, seed=0, device="cpu")
    jcache, jst = jeng.fresh_state()
    for r in jdraw_requests(3, 6, 3, 10, jc.vocab_size, seed=4):
        prompt = np.zeros(SCFG["prompt_pad"], np.int32)
        prompt[:len(r.tokens)] = r.tokens
        jcache, jst, _ = jeng._admit(jp, jcache, jst, jnp.asarray(prompt),
                                     jnp.int32(len(r.tokens)),
                                     jnp.int32(r.max_new),
                                     jnp.int32(r.req_id))
    np_cache = jax.tree_util.tree_map(np.array, jcache)
    np_st = jax.tree_util.tree_map(np.array, jst)
    pools = interop.pools_from_numpy(np_cache)
    st = interop.slot_state_from_numpy(np_st, torch.Generator())
    jcache, jst, jout = jeng._decode(jp, jcache, jst)
    pools, st, out = eng._decode(tp, pools, st)
    np.testing.assert_array_equal(out["next"].numpy(),
                                  np.asarray(jout["next"]))
    for f in ("tok", "length", "budget", "active", "req_id", "alloc",
              "table", "free"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), f)
    for k in ("kp", "vp"):
        np.testing.assert_allclose(pools["b0"][k][:, :-1].numpy(),
                                   np.asarray(jcache["b0"][k]), atol=1e-5)


def test_paged_quant_scales_within_one_ulp_of_jitted_jax():
    """On the same K rows: jitted JAX multiplies amax by the reciprocal of
    127, the port divides (eager JAX's value), so scales differ by at most
    one ulp and codes by at most one level."""
    from repro.models.attention import _paged_quant as jquant
    from repro_torch.models.attention import _paged_quant
    x = np.random.default_rng(0).standard_normal((64, 16, 2, 64),
                                                 np.float32)
    jq, js = jax.jit(jquant)(jnp.asarray(x))
    q, s = _paged_quant(torch.from_numpy(x))
    js = np.asarray(js)
    assert (np.abs(s.numpy() - js) <= np.spacing(js)).all()
    assert np.abs(q.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1


def test_churn_conserves_pages_and_counts_tokens(tiny):
    _, tc, _, tp = tiny
    engine = ServeEngine(tc, ServeConfig(**SCFG), tp, seed=2, device="cpu")
    reqs = draw_requests(12, 6, 2, 30, tc.vocab_size, seed=7)
    results, stats = engine.run(reqs)
    assert [len(results[r.req_id]) for r in reqs] == \
        [r.max_new for r in reqs]
    assert stats["tokens"] == sum(r.max_new for r in reqs)
    assert stats["free_pages_end"] == engine.scfg.total_pages
    assert len(stats["step_s"]) == stats["steps"]


def test_max_new_1_completes_at_admission(tiny):
    _, tc, _, tp = tiny
    engine = ServeEngine(tc, ServeConfig(**SCFG), tp, device="cpu")
    results, stats = engine.run([Request(0, (1, 2, 3), 1)])
    assert len(results[0]) == 1
    assert stats["steps"] == 0
    assert stats["free_pages_end"] == engine.scfg.total_pages


def test_paged_matches_dense_full_cache(tiny):
    jc, tc, jp, tp = tiny
    model = build(tc)
    plen, gen = 5, 8
    prompt = tuple(np.random.RandomState(3)
                   .randint(0, tc.vocab_size, plen).tolist())
    engine = ServeEngine(tc, ServeConfig(**SCFG), tp, device="cpu")
    results, _ = engine.run([Request(0, prompt, gen)])
    cache = model.init_cache(1, plen + gen, dtype=torch.float32)
    logits, cache = model.prefill(tp, {"tokens": torch.tensor([prompt])},
                                  cache)
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    step = make_decode_step(model, temperature=0.0)
    dense = [int(tok[0, 0])]
    for i in range(gen - 1):
        tok, cache, _ = step(tp, tok, cache, plen + i, None)
        dense.append(int(tok[0, 0]))
    assert results[0] == dense


def test_sampling_pure_function_fed_jax_gumbel():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((5, 300)).astype(np.float32) * 3
    for seed, temp in ((0, 0.7), (1, 1.0), (2, 2.5)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(lg) / temp))
        g = np.array(jax.random.gumbel(key, lg.shape, jnp.float32))
        got = serve_engine.sample(torch.from_numpy(lg), temp,
                                  torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        serve_engine.sample(torch.from_numpy(lg), 0.0).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(lg), -1)))


def test_sampled_engine_is_seeded_and_complete(tiny):
    _, tc, _, tp = tiny
    scfg = ServeConfig(**SCFG, temperature=0.8)
    reqs = draw_requests(5, 6, 2, 12, tc.vocab_size, seed=3)
    a, _ = ServeEngine(tc, scfg, tp, seed=4, device="cpu").run(reqs)
    b, _ = ServeEngine(tc, scfg, tp, seed=4, device="cpu").run(reqs)
    assert a == b
    assert [len(a[r.req_id]) for r in reqs] == [r.max_new for r in reqs]


def test_launch_main_rehearses_on_cpu(capsys, tmp_path):
    import json
    from repro_torch.obs.check import check_jsonl, check_trace
    for engine in ("continuous", "dense"):
        launch_serve.main(["--arch", "tiny-lm", "--reduced", "--device",
                           "cpu", "--requests", "3", "--gen-min", "2",
                           "--gen-max", "6", "--engine", engine])
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["device"] == "cpu" and row["tokens"] > 0
    # telemetry: a trace and a JSONL stream that pass the schema checks
    trace, jsonl = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    launch_serve.main(["--arch", "tiny-lm", "--reduced", "--device", "cpu",
                       "--requests", "3", "--gen-min", "2", "--gen-max", "6",
                       "--trace", trace, "--telemetry-jsonl", jsonl])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["tokens"] > 0
    assert not check_trace(trace, min_phases=5)
    assert not check_jsonl(jsonl, require_obs=True, engine="serve")
