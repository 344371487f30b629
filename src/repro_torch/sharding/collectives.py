"""The collectives of the sharded robust aggregation, over a mesh's process
group (``launch/mesh.py``): the counterparts of what GSPMD inserts around
the JAX package's ``shard_map`` (``aggregation.aggregate_sharded``).

A rank holds the rows of its own clients, (C/W, N) with the columns in leaf
order.  ``ColumnShards.to_columns`` turns them into the (C, n/W) column
shards of every split leaf by one ``all_to_all`` (the reshard that JAX's
``with_sharding_constraint`` folds into the producer) and gathers the rows
of the leaves that stay whole; ``ColumnShards.gather`` all-gathers each
leaf's aggregated shards back into its (n,) row.  At W = 1 the all_to_all is the
identity and is not called (the rows are already the columns); every other
collective goes through ``torch.distributed`` at every world size, so a
world-size-1 run takes the same path as a wider one.  Every call is safe
to record as a CUDA graph: the buffers come from ``torch.empty`` and the
collectives are NCCL's (``launch/mesh.py`` starts the group).

Each runs over the group of the ``mesh`` it is given; a sub-group (the
ranks that share this rank's coordinates on the axes not named) is the
mesh ``Mesh.over(axes)``, and "W" below is then that sub-group's size,
"rank" this rank's index in it.
"""
from __future__ import annotations

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

    def _cols(self, x, sharded, p=0):
        """The columns of ``x`` (rows, N) that go to the shard matrix of rank
        ``p`` (``sharded``) or to the matrix of whole leaves, in leaf order."""
        out = []
        for n, f, a in zip(self.sizes, self.flags, self.offsets):
            if f and sharded:
                b = n // self.w
                out.append(x[:, a + p * b:a + (p + 1) * b])
            elif not f and not sharded:
                out.append(x[:, a:a + n])
        return out

    def to_columns(self, x):
        """This rank's clients' rows ``x`` (C/W, N) -> ``(sh, rep)``: the
        (C, sum sh_sizes) shard matrix and the (C, sum rep_sizes) whole
        leaves, both contiguous, rows in client order."""
        r = x.shape[0]
        if self.w == 1 and self.whole:
            return x.contiguous(), x[:, :0]
        send = torch.stack([torch.cat(self._cols(x, True, p), 1)
                            if self.sh_sizes else x[:, :0]
                            for p in range(self.w)])      # (W, r, n_sh)
        sh = send if self.w == 1 else all_to_all(send, self.mesh)
        sh = sh.reshape(self.w * r, -1)
        rep = (all_gather_rows(torch.cat(self._cols(x, False), 1),
                               self.mesh)
               if self.rep_sizes else x.new_empty(self.w * r, 0))
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
