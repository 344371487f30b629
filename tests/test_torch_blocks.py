"""Every assigned architecture in the port against the JAX package, at
``reduced()`` sizes on the CPU, from JAX's own init carried across by
``interop`` (mirroring ``tests/test_arch_smoke.py``): the configs field by
field, the params' structure and shapes, the forward, the loss with the
MoE aux loss, prefill + decode against JAX's, and the caches of every
block kind.  Then cross-attention and the sliding-window ring cache
(prompts longer than the window, decodes that wrap the ring more than
once), and paged serving of ``granite-moe-1b-a400m.reduced()`` (its MoE
layers routing every slot's row) giving JAX's engine's tokens at T = 0.

Tolerances: logits within 1e-5 of their largest (fp32 matmuls, scans and
softmaxes in other orders; llama-3.2-vision's zero-init cross-attention
gates are set to 0.5 so that its image path counts), the loss and aux
within 1e-5; the attention branches within 2e-4 (the JAX tests' bound);
tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import ASSIGNED as JASSIGNED
from repro.launch.serve import draw_requests as jdraw_requests
from repro.models import attention as jattn
from repro.models import transformer as jtransformer
from repro.models.model import build as jbuild
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch import interop, tree
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config
from repro_torch.models import attention, transformer
from repro_torch.models.model import build
from repro_torch.serve import Request, ServeConfig, ServeEngine
from repro_torch.serve import engine as serve_engine

REL = 1e-5
ATTN_ATOL = 2e-4
B, S = 2, 16
# reduced() keeps 2 layers, which for llama-3.2-vision are both ``attn``
# (its cross-attention is every 5th): the "+xattn" case sets
# cross_attn_every=2, layers (attn, xattn)
XATTN = "llama-3.2-vision-90b+xattn"
NEW = ["granite-moe-1b-a400m", "dbrx-132b", "hymba-1.5b", "xlstm-350m",
       "llama-3.2-vision-90b", "musicgen-large"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small models: one intra-op thread keeps the suite's parallel workers
    from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(port, ref, rel=REL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _gate_open(jp):
    """JAX's params with every cross-attention gate at 0.5 (init: 0)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.5 if "gate" in jax.tree_util.keystr(p) else x, jp)


def _reduced(name, archs):
    base, _, variant = name.partition("+")
    cfg = archs[base].reduced()
    return cfg.replace(cross_attn_every=2) if variant == "xattn" else cfg


@pytest.fixture(scope="module", params=ASSIGNED + [XATTN])
def arch(request):
    name = request.param
    jc, tc = _reduced(name, JARCHS), _reduced(name, ARCHS)
    assert ("xattn" in tc.layers) == (name == XATTN)
    jp = _gate_open(jbuild(jc).init(jax.random.PRNGKey(0)))
    return name, jc, tc, jp, interop.params_from_numpy(_np(jp))


def _inputs(cfg, seed=1):
    rng = np.random.RandomState(seed)
    inp = {}
    if cfg.embed_inputs:
        inp["tokens"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        inp["embeds"] = rng.randn(B, S, cfg.d_model).astype(np.float32)
    if cfg.arch_type == "vlm":
        inp["image_embeds"] = rng.randn(B, cfg.n_image_tokens,
                                        cfg.d_model).astype(np.float32)
    return inp


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------- configs --
def test_registry_is_jax_registry():
    assert ASSIGNED == JASSIGNED and list(ARCHS) == list(JARCHS)


@pytest.mark.parametrize("name", NEW)
def test_configs_equal_jax_field_by_field(name):
    j, t = JARCHS[name], get_config(name)
    for a, b in ((t, j), (t.reduced(), j.reduced())):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
        for prop in ("layers", "padded_vocab", "resolved_head_dim",
                     "resolved_dt_rank", "d_inner"):
            assert getattr(a, prop) == getattr(b, prop), prop
        assert transformer.layer_cycle(a) == jtransformer.layer_cycle(b)


# ----------------------------------------------------------- every arch --
def test_init_has_jax_structure_and_shapes(arch):
    _, jc, tc, jp, _ = arch
    port = build(tc).init(torch.Generator().manual_seed(0))
    jl, js = jax.tree_util.tree_flatten(_np(jp))
    assert js == jax.tree_util.tree_flatten(interop.params_to_numpy(port))[1]
    assert [a.shape for a in jl] == [tuple(t.shape)
                                     for t in tree.leaves(port)]
    assert all(np.isfinite(a.numpy()).all() for a in tree.leaves(port))


def test_forward_and_loss_match_jax(arch):
    _, jc, tc, jp, tp = arch
    inp = _inputs(jc)
    jl = jbuild(jc).forward(jp, _j(inp))
    tl = build(tc).forward(tp, _t(inp))
    assert tuple(tl.shape) == (B, S, tc.padded_vocab)
    _close(tl, jl)
    batch = dict(inp, targets=np.random.RandomState(2).randint(
        0, jc.vocab_size, (B, S)).astype(np.int32))
    jloss, jm = jbuild(jc).loss(jp, _j(batch))
    tloss, tm = build(tc).loss(tp, _t(batch))
    assert abs(float(tloss) - float(jloss)) <= REL
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= REL
    assert (float(tm["aux"]) > 0) == (tc.arch_type == "moe")
    assert float(tm["acc"]) == float(jm["acc"])


def test_prefill_and_decode_match_jax(arch):
    """``test_arch_smoke.test_decode_matches_forward`` on both packages:
    prefill of S - 1 inputs, then the last one decoded; each against JAX's
    and the decode against the full forward's last position."""
    _, jc, tc, jp, tp = arch
    jm, tm = jbuild(jc), build(tc)
    inp = _inputs(jc, seed=3)
    full = tm.forward(tp, _t(inp))
    pre = {k: (v[:, :S - 1] if k != "image_embeds" else v)
           for k, v in inp.items()}
    last = {k: v[:, S - 1:S] for k, v in inp.items() if k != "image_embeds"}
    jcache = jm.init_cache(B, S + 4, dtype=jnp.float32)
    tcache = tm.init_cache(B, S + 4, dtype=torch.float32)
    jl, jcache = jm.prefill(jp, _j(pre), jcache)
    tl, same = tm.prefill(tp, _t(pre), tcache)
    assert same is tcache
    _close(tl, jl)
    jl, jcache = jm.decode(jp, _j(last), jcache, jnp.int32(S - 1))
    tl, tcache = tm.decode(tp, _t(last), tcache, S - 1)
    _close(tl, jl)
    _close(tl[:, 0], full[:, -1].numpy(), 2e-5)
    for (jpath, jleaf), tleaf in zip(
            jax.tree_util.tree_flatten_with_path(jcache)[0],
            tree.leaves(tcache)):
        _close(tleaf, jleaf, 1e-4)


@pytest.mark.parametrize("ring", [False, True])
def test_init_cache_matches_jax(arch, ring):
    _, jc, tc, _, _ = arch
    if ring:
        jc, tc = (c.replace(sliding_window=c.sliding_window or 8)
                  for c in (jc, tc))
    j = jtransformer.init_cache(jc, 3, 20, ring=ring, dtype=jnp.float32)
    t = transformer.init_cache(tc, 3, 20, ring=ring, dtype=torch.float32)
    jl, js = jax.tree_util.tree_flatten(_np(j))
    assert js == jax.tree_util.tree_flatten(interop.params_to_numpy(t))[1]
    for a, b in zip(jl, tree.leaves(t)):
        np.testing.assert_array_equal(b.numpy(), a)


# --------------------------------------------------- attention branches --
def _attn(seed=1, **kw):
    jc = JARCHS["minitron-4b"].reduced().replace(**kw)
    tc = ARCHS["minitron-4b"].reduced().replace(**kw)
    jp = _np(jattn.init_attention(jax.random.PRNGKey(seed), jc))
    return jc, tc, jp, interop.params_from_numpy(jp)


def test_cross_attention_prefill_stores_kv_and_decode_reuses_it():
    jc, tc, jp, tp = _attn(n_image_tokens=12)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 12, jc.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    shape = (2, 12, jc.n_kv_heads, jc.resolved_head_dim)
    jcache = {"ck": jnp.zeros(shape), "cv": jnp.zeros(shape)}
    tcache = {"ck": torch.zeros(shape), "cv": torch.zeros(shape)}
    pos = np.arange(5)[None]
    jo, jcache = jattn.attention_fwd(jp, jnp.asarray(x), jc, pos,
                                     cache=jcache, kv_source=jnp.asarray(img))
    to, same = attention.attention_fwd(tp, torch.from_numpy(x), tc,
                                       torch.from_numpy(pos), cache=tcache,
                                       kv_source=torch.from_numpy(img))
    assert same is tcache
    _close(to, jo, ATTN_ATOL)
    for k in ("ck", "cv"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   atol=ATTN_ATOL)
        assert float(tcache[k].abs().max()) > 0
    # no cache: the same output (train / scoring)
    to2, none = attention.attention_fwd(tp, torch.from_numpy(x), tc,
                                        torch.from_numpy(pos),
                                        kv_source=torch.from_numpy(img))
    assert none is None
    torch.testing.assert_close(to2, to, rtol=0, atol=0)
    # decode reads the cache (no kv_source), no rope: position-free
    x1 = x[:, :1].copy()
    for p in (5, 900):
        jo, _ = jattn.attention_fwd(jp, jnp.asarray(x1), jc,
                                    np.array([[p]]), cache=jcache)
        to, _ = attention.attention_fwd(tp, torch.from_numpy(x1), tc,
                                        torch.tensor([[p]]), cache=tcache)
        _close(to, jo, ATTN_ATOL)
        _close(to, np.asarray(to2[:, :1]), 1e-6)


@pytest.mark.parametrize("window", [8, 5])
def test_ring_cache_wraps_and_matches_jax(window):
    """W = window = 8 (5): a 20-token prompt (longer than W) fills the ring's
    last slots, then 19 decodes wrap it more than twice; every output
    against JAX's ring path and against a full cache with the same window,
    and the ring's K rows and position against JAX's."""
    jc, tc, jp, tp = _attn(sliding_window=window)
    W = window
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((2, 39, jc.d_model)).astype(np.float32)
    jring = jattn.init_kv_cache(jc, 2, W, ring=True, dtype=jnp.float32)
    tring = attention.init_kv_cache(tc, 2, W, ring=True, dtype=torch.float32)
    assert tuple(tring["k"].shape) == (2, W, tc.n_kv_heads,
                                       tc.resolved_head_dim)
    tfull = attention.init_kv_cache(tc, 2, 39, dtype=torch.float32)
    steps = [(0, 20)] + [(t, t + 1) for t in range(20, 39)]
    for lo, hi in steps:
        x = xs[:, lo:hi]
        pos = np.arange(lo, hi)[None]
        jo, jring = jattn.attention_fwd(jp, jnp.asarray(x), jc, pos,
                                        window=W, cache=jring)
        to, _ = attention.attention_fwd(tp, torch.from_numpy(x.copy()), tc,
                                        torch.from_numpy(pos), window=W,
                                        cache=tring)
        fo, _ = attention.attention_fwd(tp, torch.from_numpy(x.copy()), tc,
                                        torch.from_numpy(pos), window=W,
                                        cache=tfull)
        _close(to, jo, ATTN_ATOL)
        _close(to, fo.numpy(), ATTN_ATOL)
        assert int(tring["pos"]) == int(jring["pos"]) == hi
        np.testing.assert_allclose(tring["k"].numpy(), np.asarray(jring["k"]),
                                   atol=ATTN_ATOL)


def test_ring_prefill_starts_at_position_zero():
    _, tc, _, tp = _attn(sliding_window=8)
    ring = attention.init_kv_cache(tc, 1, 8, ring=True, dtype=torch.float32)
    x = torch.randn(1, 3, tc.d_model, generator=torch.Generator().manual_seed(0))
    attention.attention_fwd(tp, x[:, :1], tc, torch.zeros(1, 1), window=8,
                            cache=ring)
    with pytest.raises(ValueError, match="position 0"):
        attention.attention_fwd(tp, x, tc, torch.arange(1, 4)[None],
                                window=8, cache=ring)


def test_model_ring_cache_decode_matches_forward():
    """``test_arch_smoke.test_ring_cache_decode_sliding_window`` on the port
    and against JAX: a window of 8 over 16 tokens, hymba's hybrid blocks
    (ring + mamba state) and qwen's."""
    for name in ("qwen2.5-14b", "hymba-1.5b"):
        jc = JARCHS[name].reduced().replace(sliding_window=8)
        tc = ARCHS[name].reduced().replace(sliding_window=8)
        jp = jbuild(jc).init(jax.random.PRNGKey(0))
        tp = interop.params_from_numpy(_np(jp))
        toks = _inputs(jc, 4)["tokens"]
        full = build(tc).forward(tp, _t({"tokens": toks}))
        jm, tm = jbuild(jc), build(tc)
        jcache = jm.init_cache(B, S + 4, ring=True, dtype=jnp.float32)
        tcache = tm.init_cache(B, S + 4, ring=True, dtype=torch.float32)
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S - 1])},
                               jcache)
        _, tcache = tm.prefill(tp, _t({"tokens": toks[:, :S - 1]}), tcache)
        ring = tcache["b0"]["attn"] if name == "hymba-1.5b" \
            else tcache["b0"]
        assert ring["k"].shape[2] == 8
        jl, _ = jm.decode(jp, {"tokens": jnp.asarray(toks[:, S - 1:])},
                          jcache, jnp.int32(S - 1))
        tl, _ = tm.decode(tp, _t({"tokens": toks[:, S - 1:]}), tcache, S - 1)
        _close(tl, jl)
        _close(tl[:, 0], full[:, -1].numpy(), 2e-5)


# ---------------------------------------------------------------- serving --
SCFG = dict(max_slots=4, page_size=8, max_len=48, prompt_pad=8)


@pytest.fixture(scope="module")
def granite():
    jc = JARCHS["granite-moe-1b-a400m"].reduced()
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    return (jc, ARCHS["granite-moe-1b-a400m"].reduced(), jp,
            interop.params_from_numpy(_np(jp)))


@pytest.mark.parametrize("attn", ["ref", "pallas"])
def test_paged_serving_moe_tokens_match_jax(granite, attn):
    """Continuous batching at T = 0 over reduced granite: every request's
    tokens JAX's engine's (K8's plain version against JAX's Pallas kernel
    in interpret mode under ``pallas``), and the same steps."""
    jc, tc, jp, tp = granite
    reqs = jdraw_requests(8, 6, 2, 20, jc.vocab_size, seed=3)
    jres, jstats = JServeEngine(jc, JServeConfig(**SCFG, attn=attn), jp,
                                seed=1).run(reqs)
    engine = ServeEngine(tc, ServeConfig(**SCFG, attn=attn), tp, seed=1,
                         device="cpu")
    res, stats = engine.run([Request(r.req_id, r.tokens, r.max_new)
                             for r in reqs])
    assert res == jres
    assert stats["steps"] == jstats["steps"]
    assert stats["free_pages_end"] == engine.scfg.total_pages


def test_paged_serving_rejects_other_cycles():
    for name in ("hymba-1.5b", "xlstm-350m", XATTN):
        with pytest.raises(ValueError, match="attn/moe"):
            serve_engine.init_paged_cache(_reduced(name, ARCHS),
                                          ServeConfig(**SCFG), "cpu")
