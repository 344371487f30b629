"""K9 (``flash_attention_fwd``) of the port against the JAX package on the
same numpy inputs: on the CPU the port runs K9's plain version; the JAX
side runs its Pallas kernel in interpret mode, over the sweep of
``tests/test_kernels.py::test_flash_attention_sweep``.
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the CUDA kernel
against the plain version on the card.  K9 is forward only, as the
reference's Pallas path: under grad with an input that requires grad it
raises (held here on the CPU), and forward-only use runs as before.

Tolerances: fp32 within 1e-5 (the two online softmaxes visit key blocks of
64 and 128 rows, so they sum in other orders); bf16 within one bf16 ulp of
the output plus that fp32 tolerance: both round to nearest an fp32 value
that differs in its last bits, and near zero (outputs of ~1e-6) that fp32
difference is itself larger than a bf16 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jfwd
from repro.kernels.flash_attention_ops import flash_attention as jops
from repro.kernels.flash_attention_ref import flash_attention_ref as jref
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_ops
from repro_torch.kernels.flash_attention_ref import flash_attention_ref
from repro_torch.kernels.robust_pipeline import SMEM_LIMIT
from repro_torch.models.model import build

FP32_ATOL = 1e-5


def _qkv(B, S, Hq, Hkv, dh, seed=0):
    """(B, H, S, dh) fp32 arrays (the kernel layout)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, h, S, dh), np.float32)
            for h in (Hq, Hkv, Hkv)]


def _bf16_ulp(x):
    """One bf16 ulp at each element of x (fp32 numpy)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _cast(arrays, dtype):
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in j]
    if dtype == jnp.bfloat16:
        t = [x.bfloat16() for x in t]
    return j, t


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [0, 64, 128])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_plain_k9_matches_pallas_sweep(S, Hq, Hkv, window, dtype):
    j, t = _cast(_qkv(2, S, Hq, Hkv, 128), dtype)
    out = fa.flash_attention_fwd(*t, causal=True, window=window)
    kern = np.asarray(jfwd(*j, causal=True, window=window,
                           interpret=True).astype(jnp.float32))
    got = out.float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, kern, atol=FP32_ATOL)
    else:
        assert out.dtype == torch.bfloat16
        assert (np.abs(got - kern) <= _bf16_ulp(kern) + FP32_ATOL).all()


@pytest.mark.parametrize("S,dh,window", [(200, 64, 0), (200, 64, 48),
                                         (77, 128, 0), (1, 64, 0),
                                         (384, 64, 100)])
def test_plain_k9_ragged_and_small_head_dims_match_oracle(S, dh, window):
    arrays = _qkv(2, S, 6, 2, dh, seed=S)
    t = [torch.from_numpy(a) for a in arrays]
    out = fa.flash_attention_fwd(*t, causal=True, window=window)
    ref = np.asarray(jref(*[jnp.asarray(a) for a in arrays], causal=True,
                          window=window))
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)
    np.testing.assert_allclose(
        flash_attention_ref(*t, causal=True, window=window).numpy(), ref,
        atol=FP32_ATOL)


def test_plain_k9_non_causal_matches_oracle():
    arrays = _qkv(1, 150, 4, 2, 64, seed=3)
    t = [torch.from_numpy(a) for a in arrays]
    out = fa.flash_attention_fwd(*t, causal=False)
    ref = np.asarray(jref(*[jnp.asarray(a) for a in arrays], causal=False))
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)


def test_ops_wrapper_keeps_the_model_layout():
    """(B, S, H, dh) in and out, transposed as JAX's wrapper does."""
    arrays = [np.ascontiguousarray(a.transpose(0, 2, 1, 3))
              for a in _qkv(2, 256, 4, 2, 128, seed=1)]
    out = flash_attention_ops.flash_attention(
        *[torch.from_numpy(a) for a in arrays], causal=True, window=64)
    ref = np.asarray(jops(*[jnp.asarray(a) for a in arrays], causal=True,
                          window=64, interpret=True))
    assert tuple(out.shape) == arrays[0].shape
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)


@pytest.mark.parametrize("q0,window,lo_hi", [(0, 0, (0, 1)),
                                             (128, 0, (0, 3)),
                                             (128, 64, (1, 3)),
                                             (192, 64, (2, 4)),
                                             (192, 66, (1, 4))])
def test_kv_block_range_is_the_live_band(q0, window, lo_hi):
    """The tiles K9 visits are exactly those holding a live key for some
    row of the q tile."""
    s = 256
    assert fa.kv_block_range(q0, q0 + fa.BLK, s, True, window) == lo_hi
    rows = np.arange(q0, q0 + fa.BLK)[:, None]
    cols = np.arange(s)[None, :]
    live = cols <= rows
    if window:
        live &= cols > rows - window
    tiles = np.nonzero(live.reshape(fa.BLK, -1, fa.BLK).any((0, 2)))[0]
    assert (tiles.min(), tiles.max() + 1) == lo_hi


@pytest.mark.parametrize("tile", [fa.BLK, fa.MMA_Q_TILE])
@pytest.mark.parametrize("S,window", [(77, 0), (200, 0), (200, 64),
                                      (300, 64), (256, 0)])
def test_plain_k9_does_not_depend_on_its_q_tile(tile, S, window):
    """The plain version at the FMA body's 64-row and the tensor-core
    body's 128-row q tiles (64-key tiles both) against the oracle: the
    tiles change only the order of the fp32 sums, so it stays the
    kernel's yardstick after the tile change."""
    arrays = _qkv(2, S, 6, 2, 64, seed=S + window)
    t = [torch.from_numpy(a) for a in arrays]
    out = fa.flash_attention_fwd_plain(*t, causal=True, window=window,
                                       tile=tile)
    ref = np.asarray(jref(*[jnp.asarray(a) for a in arrays], causal=True,
                          window=window))
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)
    other = fa.BLK + fa.MMA_Q_TILE - tile
    np.testing.assert_allclose(
        out.numpy(), fa.flash_attention_fwd_plain(
            *t, causal=True, window=window, tile=other).numpy(),
        atol=FP32_ATOL)


def test_plain_k9_takes_the_tiles_of_the_body_the_kernel_takes():
    assert fa.q_tile(torch.bfloat16, 128) == fa.MMA_Q_TILE
    assert fa.q_tile(torch.bfloat16, 72) == fa.BLK
    assert fa.q_tile(torch.float32, 128) == fa.BLK
    assert fa.tensor_cores(torch.bfloat16, 64)
    assert not fa.tensor_cores(torch.bfloat16, 40)
    assert not fa.tensor_cores(torch.float32, 64)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_k9_shared_memory_fits(dtype, dh):
    assert 0 < fa.smem_bytes(dh, dtype) <= SMEM_LIMIT


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("entry", ["fwd", "ops"])
def test_k9_raises_under_grad(which, entry):
    """An input that requires grad, with grad enabled, raises on the CPU
    too (the reference's Pallas path raises under jax.grad); K9 never
    returns an output that drops the attention's gradient."""
    t = [torch.from_numpy(a) for a in _qkv(1, 128, 2, 1, 64, seed=2)]
    t[which].requires_grad_(True)
    if entry == "ops":
        t = [x.transpose(1, 2) for x in t]
        call = flash_attention_ops.flash_attention
    else:
        call = fa.flash_attention_fwd
    with pytest.raises(RuntimeError, match="forward only"):
        call(*t, causal=True)
    with torch.no_grad():
        out = call(*t, causal=True)
    ref = call(*[x.detach() for x in t], causal=True)
    assert out.grad_fn is None and ref.grad_fn is None
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_transformer_pallas_forward_runs_on_plain_params():
    """The model's params carry no requires_grad, so the full-sequence
    forward through K9 at S = 128 runs as before; params that require
    grad make it raise instead of training without the attention's
    gradient."""
    cfg = registry.get_config("minitron-4b").reduced().replace(
        n_heads=2, n_kv_heads=1, head_dim=128, attn_impl="pallas")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.from_numpy(_tokens(cfg, 2, 128))}
    out = model.forward(params, toks)
    assert out.shape[:2] == (2, 128) and bool(torch.isfinite(out).all())
    for p in params["layers"]["b0"]["attn"].values():
        p.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        model.forward(params, toks)


def _tokens(cfg, b, s):
    return np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (b, s)).astype(np.int64)
