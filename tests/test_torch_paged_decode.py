"""K8 (``paged_flash_decode``) of the port against the JAX package on the
same numpy inputs.  On the CPU the port runs K8's plain version; the JAX
side runs its Pallas kernel in interpret mode and its dense oracle, as
``tests/test_serve.py`` does.  ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` hold the CUDA kernel against the plain version on the
card.

Tolerances (``tests/test_serve.py``'s): fp32 within 1e-5 (the online and
the dense softmax sum in other orders, ~2e-7); int8 against the int8
oracle within 2e-5; int8 against fp32 within 5e-2 (quantisation error).
An inactive slot is exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode import paged_flash_decode as jdecode
from repro.kernels.paged_decode_ref import paged_decode_ref as jref
from repro.models.attention import _paged_quant as jquant
from repro_torch.kernels import paged_decode as pd
from repro_torch.kernels import paged_decode_ref as pdr
from repro_torch.models.attention import _paged_quant

FP32_ATOL = 1e-5
INT8_KERNEL_ATOL = 2e-5
INT8_QUANT_ATOL = 5e-2


def _paged(seed, s, maxp, page, hq, hkv, dh, n_extra=3):
    """Random pools + a permuted table + ragged lengths: every page full,
    page + 1 rows, one row, an inactive slot."""
    rng = np.random.default_rng(seed)
    n = s * maxp + n_extra
    q = rng.standard_normal((s, hq, dh), np.float32)
    kp = rng.standard_normal((n, page, hkv, dh), np.float32)
    vp = rng.standard_normal((n, page, hkv, dh), np.float32)
    table = rng.permutation(n)[:s * maxp].reshape(s, maxp).astype(np.int32)
    lengths = rng.integers(1, maxp * page + 1, s).astype(np.int32)
    lengths[0] = maxp * page
    lengths[1] = page + 1
    lengths[2] = 1
    lengths[3] = 0
    return q, kp, vp, table, lengths


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [(page, maxp, hq, hkv, dh)
         for page, maxp in [(4, 6), (8, 3), (16, 2)]
         for hq, hkv in [(4, 2), (6, 2)]
         for dh in [64, 128]]


@pytest.mark.parametrize("page,maxp,hq,hkv,dh", CASES)
def test_plain_k8_matches_pallas_and_oracle(page, maxp, hq, hkv, dh):
    args = _paged(page * dh + hq, 5, maxp, page, hq, hkv, dh)
    out = pd.paged_flash_decode(*_t(*args))
    kern = np.asarray(jdecode(*_j(*args), interpret=True))
    ref = np.asarray(jref(*_j(*args)))
    np.testing.assert_allclose(out.numpy(), kern, atol=FP32_ATOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=FP32_ATOL)
    assert float(out[3].abs().max()) == 0.0           # inactive slot
    np.testing.assert_allclose(pdr.paged_decode_ref(*_t(*args)).numpy(),
                               ref, atol=FP32_ATOL)


@pytest.mark.parametrize("dh", [64, 128])
def test_int8_matches_int8_oracle_and_fp32(dh):
    q, kp, vp, table, lengths = _paged(11 + dh, 5, 3, 8, 4, 2, dh)
    kq, ks = _paged_quant(torch.from_numpy(kp))
    vq, vs = _paged_quant(torch.from_numpy(vp))
    jkq, jks = jquant(jnp.asarray(kp))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    qt, tt, lt = _t(q, table, lengths)
    out8 = pd.paged_flash_decode(qt, kq, vq, tt, lt, k_scale=ks, v_scale=vs)
    jargs = _j(q, kq.numpy(), vq.numpy(), table, lengths)
    jscales = dict(k_scale=jnp.asarray(ks.numpy()),
                   v_scale=jnp.asarray(vs.numpy()))
    kern = np.asarray(jdecode(*jargs, **jscales, interpret=True))
    ref = np.asarray(jref(*jargs, **jscales))
    np.testing.assert_allclose(out8.numpy(), kern, atol=INT8_KERNEL_ATOL)
    np.testing.assert_allclose(out8.numpy(), ref, atol=INT8_KERNEL_ATOL)
    out32 = np.asarray(jref(*_j(q, kp, vp, table, lengths)))
    assert float(np.abs(out8.numpy() - out32).max()) < INT8_QUANT_ATOL
    assert float(out8[3].abs().max()) == 0.0


def test_dequant_and_gather_match_jax():
    from repro.kernels.paged_decode_ref import dequant_pool, gather_pages
    q, kp, vp, table, lengths = _paged(5, 4, 3, 8, 4, 2, 64)
    kq, ks = _paged_quant(torch.from_numpy(kp))
    np.testing.assert_array_equal(
        pdr.dequant_pool(kq, ks).numpy(),
        np.asarray(dequant_pool(jnp.asarray(kq.numpy()),
                                jnp.asarray(ks.numpy()))))
    np.testing.assert_array_equal(
        pdr.gather_pages(torch.from_numpy(kp), torch.from_numpy(table)),
        np.asarray(gather_pages(jnp.asarray(kp), jnp.asarray(table))))


def test_bf16_queries_and_launch_counter_on_cpu():
    q, kp, vp, table, lengths = _paged(3, 5, 2, 16, 6, 2, 128)
    pd.reset_launch_counts()
    qb = torch.from_numpy(q).bfloat16()
    out = pd.paged_flash_decode(qb, *_t(kp, vp, table, lengths))
    ref = pdr.paged_decode_ref(qb.float(), *_t(kp, vp, table, lengths))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=FP32_ATOL, rtol=0)
    assert pd.launch_counts() == {"paged_flash_decode": 0,
                                  "paged_flash_decode[int8]": 0}
