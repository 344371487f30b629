"""The collectives of the sharded robust aggregation, over a mesh's process
group (``launch/mesh.py``): the counterparts of what GSPMD inserts around
the JAX package's ``shard_map`` (``aggregation.aggregate_sharded``).

A rank holds the rows of its own clients, C/W of them, in the send layout
(``SendRows``): each split leaf's W column blocks rank-major, (W, C/W,
n_sh), and the leaves that stay whole beside them, (C/W, n_rep).  The
producer writes them there (the pod step's per-client grads), as JAX's
``with_sharding_constraint`` has the producer emit the column layout; a
caller that holds (C/W, N) rows in leaf order packs them once
(``ColumnShards.pack``).  ``ColumnShards.to_columns`` turns the send layout
into the (C, n/W) column shards of every split leaf by one ``all_to_all``,
with no copy, and gathers the rows of the leaves that stay whole;
``ColumnShards.gather`` all-gathers each leaf's aggregated shards back into
its (n,) row.  At W = 1 the all_to_all is the identity and is not called
(the rows are already the columns); every other collective goes through
``torch.distributed`` at every world size, so a world-size-1 run takes the
same path as a wider one.  Every call is safe
to record as a CUDA graph: the buffers come from ``torch.empty`` and the
collectives are NCCL's (``launch/mesh.py`` starts the group).

Each runs over the group of the ``mesh`` it is given; a sub-group (the
ranks that share this rank's coordinates on the axes not named) is the
mesh ``Mesh.over(axes)``, and "W" below is then that sub-group's size,
"rank" this rank's index in it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


def all_reduce_sum(t, mesh):
    """Sums ``t`` over the mesh's ranks, in place; returns it."""
    dist.all_reduce(t, group=mesh.group)
    return t


def all_to_all(x, mesh):
    """(W, ...) ``x``, its block p sent to rank p -> (W, ...), block p the
    one rank p sent here."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out


def all_gather_rows(x, mesh):
    """Every rank's (r, ...) ``x``, rank-major: (W * r, ...), gathered into
    one output (no concatenation).  At W = 1 the gather runs in place on
    ``x`` (contiguous), so no second copy of an (N,) aggregate exists."""
    x = x.contiguous()
    out = x if mesh.size == 1 else x.new_empty(
        (mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


class SendRows(NamedTuple):
    """A rank's client rows in ``ColumnShards``' send layout: ``send`` (W,
    r, n_sh), block p the columns of every split leaf that go to rank p,
    and ``rep`` (r, n_rep), the leaves that stay whole."""
    send: torch.Tensor
    rep: torch.Tensor


class ColumnShards:
    """The split of a matrix whose columns are leaves of ``sizes``: leaf l
    with ``flags[l]`` (``specs.client_flat_specs``) splits into W equal
    column blocks, rank p's the p-th; the others stay whole on every rank.
    ``sh_sizes`` and ``rep_sizes`` are a rank's leaf widths in its shard
    matrix and in the matrix of whole leaves."""

    def __init__(self, sizes, flags, mesh):
        self.mesh = mesh
        self.w = self.mesh.size
        self.sizes, self.flags = tuple(sizes), tuple(flags)
        self.offsets = [0]
        for n in self.sizes:
            self.offsets.append(self.offsets[-1] + n)
        self.sh_sizes = [n // self.w for n, f in zip(self.sizes, self.flags)
                         if f]
        self.rep_sizes = [n for n, f in zip(self.sizes, self.flags) if not f]
        self.whole = all(self.flags)
        # each leaf's column offset in the send block or in ``rep``
        self.dst, o = [], [0, 0]
        for n, f in zip(self.sizes, self.flags):
            self.dst.append(o[0] if f else o[1])
            o[0 if f else 1] += n // self.w if f else n

    def empty(self, r, device, dtype=torch.float32):
        """Uninitialised ``SendRows`` for ``r`` client rows."""
        return SendRows(
            torch.empty(self.w, r, sum(self.sh_sizes), device=device,
                        dtype=dtype),
            torch.empty(r, sum(self.rep_sizes), device=device, dtype=dtype))

    def views(self, rows, c, a, m):
        """Where columns [a, a + m) of client row ``c`` lie in ``rows`` (a
        ``SendRows``): (destination view, first column, end) pieces, each
        written as ``dst.copy_(g[lo:hi].view(dst.shape))`` from the (m,)
        values ``g``.  A split leaf that lies wholly in the range is one
        strided (W, n / W) piece."""
        out = []
        for n, f, at, o in zip(self.sizes, self.flags, self.offsets,
                               self.dst):
            s, e = max(a, at), min(a + m, at + n)
            if s >= e:
                continue
            if not f:
                out.append((rows.rep[c, o + s - at:o + e - at], s - a, e - a))
                continue
            b = n // self.w
            if (s, e) == (at, at + n):
                out.append((rows.send[:, c, o:o + b], s - a, e - a))
                continue
            for p in range((s - at) // b, (e - 1 - at) // b + 1):
                lo, hi = max(s, at + p * b), min(e, at + (p + 1) * b)
                q = lo - at - p * b
                out.append((rows.send[p, c, o + q:o + q + hi - lo],
                            lo - a, hi - a))
        return out

    def pack(self, x, dtype=None):
        """Client rows in leaf order -> their ``SendRows`` (in ``dtype``,
        default ``x``'s): the one place rows are copied into the send
        layout, for a caller whose producer wrote leaf order.  ``x`` is one
        (r, N) matrix or a list of each leaf's (r, n) rows (a tree's
        leaves, read in place).  At W = 1 with every leaf split, a
        matrix in its dtype is a view."""
        leaves = (x if isinstance(x, (list, tuple)) else
                  [x[:, at:at + n] for at, n in zip(self.offsets,
                                                    self.sizes)])
        r, dtype = leaves[0].shape[0], dtype or leaves[0].dtype
        if (self.w == 1 and self.whole and isinstance(x, torch.Tensor)
                and x.dtype == dtype):
            return SendRows(x.contiguous()[None], x[:, :0])
        rows = self.empty(r, leaves[0].device, dtype)
        for x_l, n, f, o in zip(leaves, self.sizes, self.flags, self.dst):
            if f:
                b = n // self.w
                rows.send[:, :, o:o + b].copy_(
                    x_l.reshape(r, self.w, b).transpose(0, 1))
            else:
                rows.rep[:, o:o + n].copy_(x_l)
        return rows

    def to_columns(self, rows):
        """This rank's clients' ``SendRows`` -> ``(sh, rep)``: the (C, sum
        sh_sizes) shard matrix and the (C, sum rep_sizes) whole leaves,
        both contiguous, rows in client order.  No copy of the rows: the
        send buffer goes to the all_to_all as it is."""
        send, rep = rows
        r = rep.shape[0]
        sh = send if self.w == 1 else all_to_all(send, self.mesh)
        sh = sh.reshape(self.w * r, -1)
        rep = (all_gather_rows(rep, self.mesh) if self.rep_sizes
               else rep.new_empty(self.w * r, 0))
        return sh, rep

    def gather(self, out_sh, out_rep):
        """Each leaf's (n,) row, in leaf order, from this rank's aggregated
        shard ``out_sh`` (sum sh_sizes,) and the whole leaves ``out_rep``
        (sum rep_sizes,): a split leaf's W blocks all-gathered into one
        output (in place at W = 1), a whole leaf a view of ``out_rep``; no
        concatenation."""
        out, s, q = [], 0, 0
        for n, f in zip(self.sizes, self.flags):
            if f:
                b = n // self.w
                out.append(all_gather_rows(out_sh[s:s + b][None],
                                           self.mesh).reshape(-1))
                s += b
            else:
                out.append(out_rep[q:q + n])
                q += n
        return out
