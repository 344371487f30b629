"""Client->server transport codecs — port of ``repro/comm/codecs.py``.

Wire formats, with the JAX package's bytes:

  int8      blockwise absmax quantization: 1 byte/coord + one fp32 scale
            per ``qblk``-coordinate block per client
  int4      the same at 7 levels, two codes packed per byte
  signsgd   1-bit signs, 8 a byte, + the per-block mean |x|;
            ``majority_vote`` is the server-side majority-vote decode
  topk      the k = ceil(frac * n) largest-|x| coords as (int32 idx,
            fp32 val) pairs
  randk     k uniformly drawn coords, importance-scaled by n/k on decode

**Layout.**  The JAX package encodes leaf by leaf.  The round here keeps
the clients' updates in one (K, N) fp32 buffer whose columns run leaf after
leaf in JAX's flatten order (``tree.row_views``), and encodes that buffer
in one pass through a ``WireLayout``.  Every per-leaf padding (quant blocks
of ``qblk``, nibble pairs, bit octets) restarts at each leaf, so an encoded
record holds exactly the JAX package's per-leaf arrays, concatenated along
the column axis:

  int8      q (K, N) int8, s (K, NQ) fp32, NQ = sum_l ceil(n_l / qblk)
  int4      q (K, sum_l ceil(n_l / 2)) uint8, s (K, NQ)
  signsgd   bits (K, sum_l ceil(n_l / 8)) uint8, s (K, NQ)
  topk      idx (K, sum_l k_l) int32 (leaf-local), val (K, sum_l k_l) fp32
  randk     as topk

Wire bytes therefore equal JAX's per-leaf sum to the byte, and a single
leaf is the one-leaf layout (``Codec.encode``).  The int8 record is read
as it is by the fused-dequant kernels (``comm/kernels/comm_codecs.py``),
which find each column's scale through ``WireLayout.table``.

**Numerics.**  Codes and scales are JAX's bit for bit: ``amax / levels``
and ``b / s`` are fp32 divisions by tensors (a division by a Python scalar
is a multiply by its reciprocal on CUDA), and ``torch.round`` rounds half
to even like ``jnp.round``.  The decode is the one fp32 multiply ``q * s``
that the fused-dequant kernels replay.  A NaN quotient (a block whose
absmax is inf gives inf/inf; a NaN coordinate) gets **code 0**: the int8
cast of NaN is undefined in torch, and XLA's cast gives 0 too.

**Randomness.**  randk draws its indices from a ``torch.Generator``
(``draw_randk``); the encode is then a pure function of them
(``sparse_encode``), so the tests feed it JAX's own indices.
"""
from __future__ import annotations

import dataclasses
import math
from itertools import accumulate
from typing import NamedTuple, Optional

import torch

from repro_torch import tree


class QuantLeaf(NamedTuple):
    """q: (K, N) int8 codes (int4: (K, sum ceil(n_l/2)) uint8, two codes a
    byte); s: (K, NQ) fp32 per-(client, quant-block) absmax scales."""
    q: torch.Tensor
    s: torch.Tensor


class SignLeaf(NamedTuple):
    """bits: (K, sum ceil(n_l/8)) uint8 packed signs (bit 1 -> +1);
    s: (K, NQ) fp32 per-block mean |x|."""
    bits: torch.Tensor
    s: torch.Tensor


class SparseLeaf(NamedTuple):
    """idx: (K, sum k_l) int32 leaf-local indices; val: (K, sum k_l) fp32."""
    idx: torch.Tensor
    val: torch.Tensor


ENC_TYPES = (QuantLeaf, SignLeaf, SparseLeaf)


def is_encoded(x) -> bool:
    return isinstance(x, ENC_TYPES)


def _cdiv(a, b):
    return -(-a // b)


class WireLayout:
    """The leaf sizes n_l of a (K, N) update buffer and the quant block.

    Index tensors are built once per device: ``padded_index(align)`` maps
    column j of leaf l to its place in a buffer where each leaf is
    zero-padded to a multiple of ``align``; ``scale_index`` gives each
    column's scale column; ``table`` is the int32 leaf table
    [off_0 .. off_L, soff_0 .. soff_L] the fused-dequant kernels read."""

    def __init__(self, sizes, qblk):
        self.sizes = tuple(int(n) for n in sizes)
        self.qblk = int(qblk)
        self.offsets = list(accumulate([0, *self.sizes]))
        self.scale_offsets = list(accumulate(
            [0, *(_cdiv(n, self.qblk) for n in self.sizes)]))
        self.n = self.offsets[-1]
        self.n_scales = self.scale_offsets[-1]
        self._cache = {}

    def part(self, sizes):
        """The layout of leaves ``sizes`` with this quant block (a rank's
        shard of a record), kept here, so that its index tensors are built
        once, by an eager step, and found by a captured one."""
        key = ("part", tuple(int(n) for n in sizes))
        if key not in self._cache:
            self._cache[key] = WireLayout(sizes, self.qblk)
        return self._cache[key]

    def padded_len(self, align):
        return sum(_cdiv(n, align) * align for n in self.sizes)

    def _cached(self, key, device, build):
        """The index tensor ``key`` on ``device``, built on the host and
        copied there once.  A round captured as a CUDA graph finds it here,
        built by its eager warm-up step: a copy from the host cannot be
        captured, so a first build during capture raises."""
        key = (key, torch.device(device))
        if key not in self._cache:
            if (key[1].type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"WireLayout index {key[0]!r} first built during CUDA "
                    "graph capture; run one eager step before capturing")
            self._cache[key] = build().to(device)
        return self._cache[key]

    def padded_index(self, align, device):
        def build():
            parts, start = [], 0
            for n in self.sizes:
                parts.append(torch.arange(start, start + n))
                start += _cdiv(n, align) * align
            return torch.cat(parts)
        return self._cached(("pad", align), device, build)

    def scale_index(self, device):
        return self._cached(
            "sidx", device,
            lambda: self.padded_index(self.qblk, "cpu") // self.qblk)

    def block_counts(self, device):
        """(NQ,) fp32 real coordinates per quant block (a leaf's tail block
        counts only its real coords)."""
        def build():
            c = []
            for n in self.sizes:
                nq = _cdiv(n, self.qblk)
                c += [float(self.qblk)] * (nq - 1) + [float(n - (nq - 1)
                                                            * self.qblk)]
            return torch.tensor(c, dtype=torch.float32)
        return self._cached("cnt", device, build)

    def table(self, device):
        return self._cached(
            "table", device,
            lambda: torch.tensor(self.offsets + self.scale_offsets,
                                 dtype=torch.int32))

    def slot_offsets(self, frac, device):
        """(sum k_l,) column offset of each kept slot's leaf (topk, randk)."""
        return self._cached(
            ("slots", frac), device,
            lambda: torch.cat([torch.full((k,), off, dtype=torch.int64)
                               for k, off in zip(_kept(self, frac),
                                                 self.offsets)]))

    def randk_scale(self, frac, device):
        """(sum k_l,) fp32 n_l / k_l of each kept slot's leaf (randk's
        unbiased decode)."""
        return self._cached(
            ("randk", frac), device,
            lambda: torch.cat([torch.full((k,), n / k, dtype=torch.float32)
                               for n, k in zip(self.sizes,
                                               _kept(self, frac))]))


def _pad(x, layout, align):
    """(K, N) -> (K, padded_len(align)), each leaf zero-padded."""
    idx = layout.padded_index(align, x.device)
    out = x.new_zeros(x.shape[0], layout.padded_len(align))
    return out.index_copy_(1, idx, x)


def _unpad(y, layout, align):
    return y.index_select(1, layout.padded_index(align, y.device))


# ------------------------------------------------------------- int8/int4 --
def quant_encode(x, layout, levels):
    """Blockwise absmax quantization of a (K, N) matrix to ``levels``-level
    symmetric codes: q (K, N) int8 in [-levels, levels], s (K, NQ) fp32.
    A NaN quotient gets code 0 (module docstring)."""
    k = x.shape[0]
    b = _pad(x.float(), layout, layout.qblk).view(k, -1, layout.qblk)
    amax = b.abs().amax(2)
    s = torch.where(amax > 0, amax / torch.full_like(amax, levels),
                    torch.ones_like(amax))
    q = torch.clamp(torch.round(b / s[:, :, None]), -levels, levels)
    q = torch.nan_to_num(q, nan=0.0).view(k, -1)
    return _unpad(q, layout, layout.qblk).to(torch.int8), s


def quant_decode(q, s, layout):
    """Inverse of ``quant_encode``: (K, N) fp32 = q * s[scale column]."""
    return q.float() * s.index_select(1, layout.scale_index(q.device))


def pack_int4(q):
    """(K, n) int8 codes in [-7, 7] -> (K, ceil(n/2)) uint8, two 4-bit
    two's-complement nibbles a byte (low nibble = even coord)."""
    if q.shape[1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[0], 1)], dim=1)
    qp = q.to(torch.uint8)
    return (qp[:, 0::2] & 0x0F) | ((qp[:, 1::2] & 0x0F) << 4)


def unpack_int4(p, n):
    """Inverse of ``pack_int4``: both nibbles sign-extended back to int8."""
    lo = (p << 4).to(torch.int8) >> 4
    hi = p.to(torch.int8) >> 4
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[0], -1)[:, :n]


# -------------------------------------------------------------- signsgd --
def pack_bits(b):
    """(K, n) 0/1 -> (K, ceil(n/8)) uint8, LSB first: bit i of a byte is
    b << i, summed (the bit weights come from ``arange`` on the device,
    not from the host)."""
    k, n = b.shape
    if n % 8:
        b = torch.cat([b, b.new_zeros(k, (-n) % 8)], dim=1)
    shifts = torch.arange(8, dtype=torch.uint8, device=b.device)
    return (b.to(torch.uint8).view(k, -1, 8) << shifts).sum(-1).to(
        torch.uint8)


def unpack_bits(p, n):
    shifts = torch.arange(8, dtype=torch.uint8, device=p.device)
    bits = (p[:, :, None] >> shifts) & 1
    return bits.reshape(p.shape[0], -1)[:, :n]


def sign_encode(x, layout):
    """1-bit signs + per-block mean |x| (a leaf's tail block averages over
    its real coords, not the padding)."""
    k = x.shape[0]
    b = _pad(x.float(), layout, layout.qblk).view(k, -1, layout.qblk)
    s = b.abs().sum(-1) / layout.block_counts(x.device)
    bits = pack_bits(_pad((x >= 0).to(torch.uint8), layout, 8))
    return bits, s


def sign_decode(bits, s, layout):
    """Per-client decode: sign * the block's mean magnitude."""
    sg = _unpad(unpack_bits(bits, layout.padded_len(8)), layout, 8)
    return (sg.float() * 2.0 - 1.0) * s.index_select(
        1, layout.scale_index(bits.device))


def majority_vote(enc: SignLeaf, layout, mask, weights=None):
    """Server-side majority-vote decode of a cohort's sign records: the
    per-coordinate (optionally weighted) vote of the masked-in clients,
    scaled by their masked mean block magnitude.  Returns one (N,) row.
    The magnitudes are summed client by client in order, as the JAX
    package's ``tensordot`` sums them on the CPU, so the row is its row."""
    sg = _unpad(unpack_bits(enc.bits, layout.padded_len(8)), layout, 8)
    sg = sg.float() * 2.0 - 1.0
    w = mask if weights is None else weights * mask
    vote = torch.sign(w @ sg)
    ms = torch.zeros_like(enc.s[0])
    for m_k, s_k in zip(mask, enc.s):
        ms = ms + m_k * s_k
    ms = ms / torch.clamp(mask.sum(), min=1.0)
    return vote * ms.index_select(0, layout.scale_index(enc.s.device))


# ---------------------------------------------------------- top-k, rand-k --
def _kept(layout, frac):
    """Kept coords per leaf: ceil(frac * n), clamped to [1, n]."""
    return [max(1, min(n, math.ceil(frac * n))) for n in layout.sizes]


def topk_encode(x, layout, frac):
    """The k_l largest |x| of every leaf; idx leaf-local."""
    idx = torch.cat([
        torch.topk(x[:, off:off + n].abs(), k, dim=1).indices
        for n, k, off in zip(layout.sizes, _kept(layout, frac),
                             layout.offsets)], dim=1).to(torch.int32)
    return SparseLeaf(*sparse_encode(x, layout, idx, frac))


def draw_randk(k_clients, layout, frac, gen, device):
    """randk's draw: for every leaf and client, the first k_l entries of a
    uniform random permutation of its n_l coords (argsort of uniform
    noise from ``gen``); (K, sum k_l) int32 leaf-local."""
    return torch.cat([
        torch.rand(k_clients, n, generator=gen, device=device)
        .argsort(dim=1)[:, :k]
        for n, k in zip(layout.sizes, _kept(layout, frac))],
        dim=1).to(torch.int32)


def sparse_encode(x, layout, idx, frac):
    """The pure part of topk/randk: (idx, the fp32 values at idx)."""
    off = layout.slot_offsets(frac, x.device)
    return idx, torch.gather(x.float(), 1, idx.long() + off)


def sparse_decode(idx, val, layout, frac, *, rescale=False):
    """(K, N) fp32 with the kept values in place; ``rescale`` multiplies
    each leaf's values by n_l / k_l (randk's unbiased estimator)."""
    off = layout.slot_offsets(frac, val.device)
    if rescale:
        val = val * layout.randk_scale(frac, val.device)
    out = val.new_zeros(val.shape[0], layout.n)
    return out.scatter_(1, idx.long() + off, val)


# ------------------------------------------------------------ the codec --
@dataclasses.dataclass(frozen=True)
class Codec:
    """One wire format."""
    name: str                          # int8|int4|signsgd|topk|randk
    qblk: int = 128
    topk_frac: float = 0.05

    @property
    def stochastic(self) -> bool:
        return self.name == "randk"

    def layout(self, sizes) -> WireLayout:
        return WireLayout(sizes, self.qblk)

    def encode_flat(self, x, layout, gen=None):
        """Encode a (K, N) buffer laid out by ``layout``; randk draws from
        the ``torch.Generator`` ``gen``."""
        if self.name == "int8":
            return QuantLeaf(*quant_encode(x, layout, 127.0))
        if self.name == "int4":
            q, s = quant_encode(x, layout, 7.0)
            return QuantLeaf(pack_int4(_pad(q, layout, 2)), s)
        if self.name == "signsgd":
            return SignLeaf(*sign_encode(x, layout))
        if self.name == "topk":
            return topk_encode(x, layout, self.topk_frac)
        if self.name == "randk":
            if gen is None:
                raise ValueError("randk codec needs a generator at encode "
                                 "time")
            idx = draw_randk(x.shape[0], layout, self.topk_frac, gen,
                             x.device)
            return SparseLeaf(*sparse_encode(x, layout, idx,
                                             self.topk_frac))
        raise ValueError(self.name)

    def decode_flat(self, enc, layout):
        """(K, N) fp32 decode of a record laid out by ``layout``."""
        if self.name == "int8":
            return quant_decode(enc.q, enc.s, layout)
        if self.name == "int4":
            q = _unpad(unpack_int4(enc.q, layout.padded_len(2)), layout, 2)
            return quant_decode(q, enc.s, layout)
        if self.name == "signsgd":
            return sign_decode(enc.bits, enc.s, layout)
        if self.name in ("topk", "randk"):
            return sparse_decode(enc.idx, enc.val, layout, self.topk_frac,
                                 rescale=self.name == "randk")
        raise ValueError(self.name)

    # ---- one (K, ...) leaf, and trees of them, as in the JAX package ----
    def _leaf_layout(self, shape):
        return self.layout([math.prod(shape[1:])])

    def encode(self, leaf, gen=None):
        return self.encode_flat(leaf.reshape(leaf.shape[0], -1),
                                self._leaf_layout(leaf.shape), gen)

    def decode(self, enc, like):
        """Decode one record back to ``like``'s shape and dtype."""
        x = self.decode_flat(enc, self._leaf_layout(like.shape))
        return x.reshape(like.shape).to(like.dtype)

    def encode_tree(self, updates, gen=None):
        return tree.unflatten(updates, [self.encode(l, gen)
                                        for l in tree.leaves(updates)])

    def decode_tree(self, enc, like):
        return tree.unflatten(like, [
            self.decode(e, l) for e, l in
            zip(tree.leaves(enc, is_encoded), tree.leaves(like))])


def make_codec(cfg) -> Optional[Codec]:
    """The configured codec of a FedConfig (None when off)."""
    if cfg.compress == "none":
        return None
    return Codec(name=cfg.compress, qblk=cfg.compress_qblk,
                 topk_frac=cfg.compress_topk_frac)


# ---------------------------------------------------- measured byte sizes --
def wire_bytes_per_client(enc) -> float:
    """Measured uplink bytes of one client's encoded update: every array of
    the record (or tree of records), from its dtype and shape."""
    arrs = tree.leaves(enc)
    k = arrs[0].shape[0]
    return float(sum(a.numel() * a.element_size() for a in arrs)) / float(k)


def dense_bytes_per_client(updates) -> float:
    """Uncompressed uplink bytes per client of a (K, ...) update tree, from
    the leaves' actual dtype itemsizes."""
    ls = tree.leaves(updates)
    k = ls[0].shape[0]
    return float(sum(l.numel() * l.element_size() for l in ls)) / float(k)


def param_bytes(params) -> float:
    """Downlink bytes of one dense global-model broadcast."""
    return float(sum(l.numel() * l.element_size()
                     for l in tree.leaves(params)))
