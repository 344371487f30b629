"""The port's dense decoder transformer against the JAX package on the
same numpy inputs and JAX's own params (through ``interop``): the layers,
every ported ``attention_fwd`` branch, ``transformer.forward`` and
``loss_fn`` at ``minitron-4b.reduced()`` and ``tiny-lm.reduced()``, the
model facade's prefill / decode, and the configs and registry (the other
block kinds: ``tests/test_torch_blocks.py``).  A
head_dim = 128 config at S = 128 with ``attn_impl="pallas"`` makes JAX run
its flash-attention Pallas kernel (in interpret mode) and the port K9's
plain version.

Tolerance: 1e-5 in fp32 (matmuls and softmaxes sum in other orders;
logits of magnitude ~4).  The scattered K/V rows are held to it too (the
projections round differently), int8 codes within one level.
``tests/test_torch_paged_decode.py`` holds ``_paged_quant`` exact against
eager JAX on the same input.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.models.model import build as jbuild
from repro_torch import interop, tree
from repro_torch.configs import registry
from repro_torch.models import attention, layers, transformer
from repro_torch.models.model import build

ATOL = 1e-5
ARCHS = ["minitron-4b", "tiny-lm"]
DENSE = ["qwen2.5-14b", "qwen2-72b", "minitron-4b", "internlm2-20b",
         "tiny-lm", "paper-cnn", "paper-mlp"]


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


def _arch(name):
    jc = jregistry.get_config(name).reduced()
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    return (jc, registry.get_config(name).reduced(), jp,
            interop.params_from_numpy(_np(jp)))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _arch(request.param)


@pytest.fixture(scope="module")
def mini():
    """minitron-4b.reduced() for the attention branches (tiny-lm.reduced()
    has the same shapes)."""
    return _arch("minitron-4b")


def _tokens(cfg, b, s, seed=0):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (b, s)).astype(np.int32)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", DENSE)
def test_configs_equal_jax_field_by_field(name):
    j, t = jregistry.get_config(name), registry.get_config(name)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    if t.arch_type == "dense":
        jr, tr = j.reduced(), t.reduced()
        for f in dataclasses.fields(tr):
            assert getattr(tr, f.name) == getattr(jr, f.name), f.name
        assert (t.padded_vocab, t.resolved_head_dim, t.layers) == \
            (j.padded_vocab, j.resolved_head_dim, j.layers)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "xlstm-350m",
                                  "hymba-1.5b", "llama-3.2-vision-90b",
                                  "musicgen-large", "dbrx-132b"])
def test_unported_archs_raise_naming_item_13(name):
    """These names raised until their block kinds were ported: each now
    resolves to JAX's config and its reduced model builds and runs."""
    cfg = registry.get_config(name)
    assert cfg is registry.ARCHS[name]
    assert cfg.name == jregistry.get_config(name).name
    rc = cfg.reduced()
    model = build(rc)
    params = model.init(torch.Generator().manual_seed(0))
    batch = ({"tokens": torch.zeros(1, 3, dtype=torch.int64)}
             if rc.embed_inputs else {"embeds": torch.zeros(1, 3, rc.d_model)})
    if rc.arch_type == "vlm":
        batch["image_embeds"] = torch.zeros(1, rc.n_image_tokens, rc.d_model)
    logits = model.forward(params, batch)
    assert tuple(logits.shape) == (1, 3, rc.padded_vocab)
    assert torch.isfinite(logits).all()


def test_init_has_jax_structure_and_shapes(arch):
    jc, tc, jp, _ = arch
    port = build(tc).init(torch.Generator().manual_seed(0))
    jl, js = jax.tree_util.tree_flatten(_np(jp))
    assert js == jax.tree_util.tree_flatten(interop.params_to_numpy(port))[1]
    assert [a.shape for a in jl] == [tuple(t.shape)
                                     for t in tree.leaves(port)]


# ----------------------------------------------------------------- layers --
def test_rms_norm_rope_and_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 64), np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    for pos in (np.arange(9), np.arange(18).reshape(2, 9) * 7):
        for theta in (1e4, 1e6):
            _close(layers.apply_rope(torch.from_numpy(x),
                                     torch.from_numpy(pos), theta),
                   jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      theta))
    mp = {k: rng.standard_normal(s, np.float32) * 0.1 for k, s in
          (("wg", (64, 96)), ("wu", (64, 96)), ("wo", (96, 64)))}
    xm = rng.standard_normal((3, 5, 64), np.float32)
    _close(layers.mlp_fwd(interop.params_from_numpy(mp),
                          torch.from_numpy(xm), torch.float32),
           jlayers.mlp_fwd(mp, jnp.asarray(xm), jnp.float32))


# -------------------------------------------------------------- attention --
def _attn_params(cfg, seed=1, bias=False):
    jc = cfg.replace(qkv_bias=bias)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jc)
    if bias:
        jp = {k: (v + 0.1 if k.startswith("b") else v)
              for k, v in jp.items()}
    return jc, jp, interop.params_from_numpy(_np(jp))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("bias", [False, True])
def test_attention_no_cache_matches_jax(mini, window, bias):
    jc, tc, _, _ = mini
    jc, jp, tp = _attn_params(jc, bias=bias)
    tc = tc.replace(qkv_bias=bias)
    x = np.random.default_rng(2).standard_normal((2, 12, jc.d_model),
                                                 np.float32)
    pos = jnp.arange(12)[None]
    jo, _ = jattn.attention_fwd(jp, jnp.asarray(x), jc, pos, window=window)
    to, tcache = attention.attention_fwd(tp, torch.from_numpy(x), tc,
                                         torch.arange(12)[None],
                                         window=window)
    assert tcache is None
    _close(to, jo)


@pytest.mark.parametrize("window", [0, 48])
def test_attention_flash_branch_matches_jax_pallas(window):
    """head_dim 128 and S = 128: JAX's branch at attention.py:112 runs its
    Pallas kernel (interpret mode), the port's K9 (plain on the CPU)."""
    base = jregistry.get_config("minitron-4b").reduced().replace(
        d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
        attn_impl="pallas")
    jc, jp, tp = _attn_params(base)
    tc = registry.get_config("minitron-4b").reduced().replace(
        d_model=256, n_heads=2, n_kv_heads=1, head_dim=128,
        attn_impl="pallas")
    x = np.random.default_rng(3).standard_normal((2, 128, 256), np.float32)
    jo, _ = jattn.attention_fwd(jp, jnp.asarray(x), jc,
                                jnp.arange(128)[None], window=window)
    to, _ = attention.attention_fwd(tp, torch.from_numpy(x), tc,
                                    torch.arange(128)[None], window=window)
    _close(to, jo)
    xla, _ = attention.attention_fwd(tp, torch.from_numpy(x),
                                     tc.replace(attn_impl="xla"),
                                     torch.arange(128)[None], window=window)
    _close(to, xla.numpy())


def test_attention_full_cache_prefill_and_decode_match_jax(mini):
    jc, tc, _, _ = mini
    jc, jp, tp = _attn_params(jc)
    rng = np.random.default_rng(4)
    jcache = jattn.init_kv_cache(jc, 2, 16, dtype=jnp.float32)
    tcache = attention.init_kv_cache(tc, 2, 16, dtype=torch.float32)
    for s, start in ((5, 0), (1, 5), (1, 6)):
        x = rng.standard_normal((2, s, jc.d_model), np.float32)
        jpos = start + jnp.arange(s)[None]
        jo, jcache = jattn.attention_fwd(jp, jnp.asarray(x), jc, jpos,
                                         cache=jcache)
        to, tcache = attention.attention_fwd(
            tp, torch.from_numpy(x), tc, torch.from_numpy(np.array(jpos)),
            cache=tcache)
        _close(to, jo)
        _close(tcache["k"], jcache["k"])
        assert int(tcache["length"]) == int(jcache["length"])


def _paged_caches(jc, tc, int8, seed=5):
    """A JAX paged cache with random pools and scales, slot 1 inactive,
    and the port's copy (one drop page more)."""
    rng = np.random.default_rng(seed)
    slots, maxp, page, n = 3, 3, 4, 11
    jcache = jattn.init_paged_kv_cache(jc, slots, n, page, maxp, int8=int8)
    shape = jcache["kp"].shape
    if int8:
        codes = lambda: rng.integers(-127, 128, shape).astype(np.int8)
        jcache.update(kp=codes(), vp=codes(),
                      ks=rng.uniform(0.01, 0.05, shape[:-1]).astype(
                          np.float32),
                      vs=rng.uniform(0.01, 0.05, shape[:-1]).astype(
                          np.float32))
    else:
        jcache.update(kp=rng.standard_normal(shape).astype(np.float32),
                      vp=rng.standard_normal(shape).astype(np.float32))
    jcache.update(
        table=rng.permutation(n)[:slots * maxp].reshape(slots, maxp)
        .astype(np.int32),
        length=np.array([7, 3, 11], np.int32),
        active=np.array([1.0, 0.0, 1.0], np.float32),
        new_valid=np.array([5, 0, 9], np.int32))
    jcache = {k: jnp.asarray(v) for k, v in jcache.items()}
    return jcache, interop.pools_from_numpy(_np(jcache), page_axis=0)


def _pools_close(tcache, jcache):
    """The rows both scattered, where both scattered them: fp32 rows within
    ATOL (the K/V projections round differently); int8 codes within one
    level and scales within 1e-6 relative (a quotient at a rounding
    boundary); untouched rows bitwise."""
    for k in ("kp", "vp", "ks", "vs"):
        if k not in jcache:
            continue
        t, j = tcache[k][:-1].numpy(), np.asarray(jcache[k])
        if t.dtype == np.int8:
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
        elif k in ("ks", "vs"):
            np.testing.assert_allclose(t, j, rtol=1e-6)
        else:
            np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_attention_paged_prefill_matches_jax(mini, int8):
    jc, tc, _, _ = mini
    jc, jp, tp = _attn_params(jc)
    jcache, tcache = _paged_caches(jc, tc, int8)
    x = np.random.default_rng(6).standard_normal((3, 10, jc.d_model),
                                                 np.float32)
    jo, jnew = jattn.attention_fwd(jp, jnp.asarray(x), jc,
                                   jnp.arange(10)[None], cache=jcache)
    to, tnew = attention.attention_fwd(tp, torch.from_numpy(x), tc,
                                       torch.arange(10)[None], cache=tcache)
    _close(to, jo)
    _pools_close(tnew, jnew)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("int8", [False, True])
def test_attention_paged_decode_matches_jax(mini, impl, int8):
    """Decode append + attend: the dense gather reference (xla) or K8
    (pallas: JAX's Pallas kernel in interpret mode, the port's plain K8)."""
    jc, tc, _, _ = mini
    jc, jp, tp = _attn_params(jc.replace(attn_impl=impl))
    tc = tc.replace(attn_impl=impl)
    jcache, tcache = _paged_caches(jc, tc, int8, seed=7)
    x = np.random.default_rng(8).standard_normal((3, 1, jc.d_model),
                                                 np.float32)
    pos = np.array([[7], [3], [11]])
    jo, jnew = jattn.attention_fwd(jp, jnp.asarray(x), jc, jnp.asarray(pos),
                                   cache=jcache)
    to, tnew = attention.attention_fwd(tp, torch.from_numpy(x), tc,
                                       torch.from_numpy(pos), cache=tcache)
    _close(to, jo, atol=2e-5 if int8 else ATOL)
    _pools_close(tnew, jnew)


def test_unported_attention_branches_raise(mini):
    """The branches that raised until they were ported: cross-attention
    returns its cache with ``ck`` / ``cv`` filled, the ring cache has the
    window's size, and a ``moe`` forward is finite (their parity with JAX
    is ``tests/test_torch_blocks.py``'s)."""
    _, tc, _, _ = mini
    jc, _, tp = _attn_params(mini[0])
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, tc.d_model, generator=g)
    img = torch.randn(1, 5, tc.d_model, generator=g)
    shape = (1, 5, tc.n_kv_heads, tc.resolved_head_dim)
    cache = {"ck": torch.zeros(shape), "cv": torch.zeros(shape)}
    out, same = attention.attention_fwd(tp, x, tc, torch.zeros(1, 2),
                                        cache=cache, kv_source=img)
    assert same is cache and torch.isfinite(out).all()
    assert float(cache["ck"].abs().min(dim=-1).values.max()) > 0
    ring = attention.init_kv_cache(tc, 1, 4, ring=True)
    assert tuple(ring["k"].shape) == (1, 4, tc.n_kv_heads,
                                      tc.resolved_head_dim)
    assert int(ring["pos"]) == 0 and "length" not in ring
    moe_cfg = registry.get_config("granite-moe-1b-a400m").reduced()
    params = transformer.init_transformer(g, moe_cfg)
    logits, _, aux = transformer.forward(
        params, moe_cfg, tokens=torch.zeros(1, 4, dtype=torch.int64))
    assert torch.isfinite(logits).all() and float(aux) > 0


# ------------------------------------------------------------ transformer --
def test_forward_and_loss_match_jax(arch):
    jc, tc, jp, tp = arch
    toks = _tokens(jc, 2, 24)
    jl, _, _ = jtransformer.forward(jp, jc, tokens=jnp.asarray(toks))
    tl, _, aux = transformer.forward(tp, tc, tokens=torch.from_numpy(toks))
    _close(tl, jl)
    assert float(aux) == 0.0
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1),
             "mask": (np.arange(24) < 20)[None].repeat(2, 0)
             .astype(np.float32)}
    for chunk in (0, 8):
        jloss, jm = jtransformer.loss_fn(
            jp, jc.replace(loss_chunk=chunk),
            {k: jnp.asarray(v) for k, v in batch.items()})
        tloss, tm = transformer.loss_fn(
            tp, tc.replace(loss_chunk=chunk),
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(tloss) - float(jloss)) < ATOL
        assert float(tm["acc"]) == float(jm["acc"])


def test_model_forward_matches_jax_with_flash_layers():
    """A head_dim = 128 model at S = 128 under attn_impl="pallas": every
    layer's attention is JAX's Pallas kernel (interpret) / the port's K9."""
    jc = jregistry.get_config("minitron-4b").reduced().replace(
        n_heads=2, n_kv_heads=1, head_dim=128, attn_impl="pallas")
    tc = registry.get_config("minitron-4b").reduced().replace(
        n_heads=2, n_kv_heads=1, head_dim=128, attn_impl="pallas")
    jp = jbuild(jc).init(jax.random.PRNGKey(3))
    tp = interop.params_from_numpy(_np(jp))
    toks = _tokens(jc, 2, 128, seed=1)
    jl = jbuild(jc).forward(jp, {"tokens": jnp.asarray(toks)})
    tl = build(tc).forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


def test_prefill_and_decode_match_jax(arch):
    jc, tc, jp, tp = arch
    jm, tm = jbuild(jc), build(tc)
    toks = _tokens(jc, 2, 6, seed=2)
    jcache = jm.init_cache(2, 10, dtype=jnp.float32)
    tcache = tm.init_cache(2, 10, dtype=torch.float32)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcache)
    _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for pos in (6, 7):
        jl, jcache = jm.decode(jp, {"tokens": jnp.asarray(tok)}, jcache,
                               jnp.int32(pos))
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(tok)},
                               tcache, pos)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    _close(tcache["b0"]["v"], jcache["b0"]["v"])


def test_cast_params_is_the_per_call_cast():
    cfg = registry.get_config("tiny-lm").reduced().replace(dtype="bfloat16")
    params = build(cfg).init(torch.Generator().manual_seed(1))
    cast = transformer.cast_params(params, cfg)
    assert cast["ln_f"]["scale"].dtype == torch.float32
    assert cast["layers"]["b0"]["attn"]["wq"].dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(cfg, 2, 9))
    a, _, _ = transformer.forward(params, cfg, tokens=toks)
    b, _, _ = transformer.forward(cast, cfg, tokens=toks)
    assert torch.equal(a, b)
