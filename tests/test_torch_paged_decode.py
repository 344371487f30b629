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


@pytest.mark.parametrize("maxp,page,sms,s,hkv", [
    (24, 16, 132, 16, 8),        # the serving shape: 12 items, 82 CTAs a head
    (24, 16, 132, 1, 8),         # one slot: a CTA an item
    (2, 16, 132, 5, 2),          # 32 positions: one item
    (3, 1, 132, 64, 8),          # fewer positions than SPLIT_KEYS
    (37, 7, 132, 3, 4),          # a ragged last item
    (512, 16, 132, 1, 1),        # a long context: 256 items on 256 CTAs
    (24, 16, 8, 64, 8),          # a small card: 5 CTAs a head
])
def test_decode_splits_cover_every_key_once(maxp, page, sms, s, hkv):
    """K8's work items: every key position 0 .. maxp * page - 1 in exactly
    one of a slot's ``splits`` items of ``chunk`` positions, none empty at
    full length; the grid no larger than CTAS_PER_SM CTAs a SM over the
    heads, nor than the items of S full slots."""
    splits, chunk, ctas = pd.decode_splits(maxp, page, sms, s, hkv)
    total = maxp * page
    owner = np.concatenate([np.full(min(chunk, total - k * chunk), k)
                            for k in range(splits)])
    np.testing.assert_array_equal(np.sort(owner), owner)
    assert owner.shape == (total,)
    assert all((owner == k).sum() > 0 for k in range(splits))
    assert (splits - 1) * chunk < total <= splits * chunk
    assert chunk == min(pd.SPLIT_KEYS, total)
    assert 1 <= ctas <= s * splits
    assert ctas == 1 or ctas * hkv <= pd.CTAS_PER_SM * sms
    assert pd.decode_splits(maxp, page, sms, s, hkv) == (splits, chunk, ctas)


def _sub_ranges(maxp, cuts):
    edges = [0, *cuts, maxp]
    return [range(a, b) for a, b in zip(edges, edges[1:])]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cuts", [(1,), (2, 3), (1, 2, 3, 4, 5)])
def test_split_merge_matches_whole_range(cuts, int8):
    """The log-sum-exp merge of K8's split partials, in torch ops: the
    plain online softmax over page sub-ranges, merged in order, matches the
    whole-range plain output within 1e-6 (a sub-range past a slot's length
    adds nothing; the inactive slot stays exactly 0)."""
    q, kp, vp, table, lengths = _t(*_paged(31, 6, 6, 8, 6, 2, 64))
    sc = {}
    if int8:
        kp, ks = _paged_quant(kp)
        vp, vs = _paged_quant(vp)
        sc = dict(k_scale=ks, v_scale=vs)
    whole = pd.paged_flash_decode_plain(q, kp, vp, table, lengths, **sc)
    parts = [pd.paged_decode_partials_plain(q, kp, vp, table, lengths, r,
                                            **sc)
             for r in _sub_ranges(table.shape[1], cuts)]
    merged = pd.merge_split_partials_plain(parts, lengths)
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=0)
    assert float(merged[3].abs().max()) == 0.0


def test_split_merge_matches_pallas():
    """The merge the kernel implements against the Pallas kernel in
    interpret mode, at a shape where slots end in every split."""
    args = _paged(77, 5, 4, 16, 6, 2, 128)
    q, kp, vp, table, lengths = _t(*args)
    parts = [pd.paged_decode_partials_plain(q, kp, vp, table, lengths, r)
             for r in _sub_ranges(4, (1, 3))]
    merged = pd.merge_split_partials_plain(parts, lengths)
    kern = np.asarray(jdecode(*_j(*args), interpret=True))
    np.testing.assert_allclose(merged.numpy(), kern, atol=FP32_ATOL)


@pytest.mark.parametrize("g,rows", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 8),
                                    (8, 8), (12, 8)])
def test_row_block_and_smem_follow_the_layout(g, rows):
    """A K8 CTA holds its row block (the group up to 8 rows) and keeps, a
    warp, (m, l) and acc of each row in shared memory, fp32, plus the
    last-item flag; the widest legal case fits under the card's limit."""
    assert pd.row_block(g) == rows
    for dh in (50, 64, 128, 256):
        assert pd.smem_bytes(g, dh) == 4 * pd.WARPS * rows * (dh + 2) + 4
    assert pd.smem_bytes(8, 256) <= pd.SMEM_LIMIT
