"""Partition specs of the pod path — the part of
``repro/sharding/specs.py`` that the sharded robust aggregation and the
batch staging read.

A mesh here (``launch/mesh.py``) is a grid of the ranks of one
``torch.distributed`` process group, with JAX's axis names.  ``P`` is
JAX's ``PartitionSpec`` (a tuple: per dimension ``None`` or the mesh axes
it is split over), ``NamedSharding`` a spec on a mesh.  Nothing is placed
by the runtime as in GSPMD: ``NamedSharding.local`` cuts this rank's
piece out of a whole tensor, and the collectives that move pieces between
ranks are written out (``sharding/collectives.py``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch import tree


class P(tuple):
    """``PartitionSpec``: one entry a dimension, ``None`` (whole) or the
    mesh axes (a name or a tuple of names) the dimension is split over."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _axes(a):
    return a if isinstance(a, tuple) else (a,)


class NamedSharding(NamedTuple):
    mesh: Any
    spec: P

    def local(self, x):
        """This rank's piece of the whole tensor ``x``: a view, each split
        dimension cut to its block at the rank's index over its axes."""
        for d, a in enumerate(self.spec):
            if a is None:
                continue
            n = _axis_size(self.mesh, a)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                                 f"into {n}")
            size = x.shape[d] // n
            x = x.narrow(d, self.mesh.index(a) * size, size)
        return x


def _axis_size(mesh, axis):
    r = 1
    for a in _axes(axis):
        r *= mesh.shape[mesh.axis_names.index(a)]
    return r


def _dp_axes(mesh):
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


def batch_specs(batch: Any, mesh) -> Any:
    """Shard the leading (global-batch) dim over pod+data axes.  Batches
    smaller than the dp extent stay replicated on that dim.  ``batch``'s
    leaves are tensors or anything with ``shape`` and ``ndim``."""
    dp = _dp_axes(mesh)
    dp_size = _axis_size(mesh, dp)

    def spec_for(leaf):
        if leaf.ndim == 0 or leaf.shape[0] % dp_size != 0:
            return P(*([None] * leaf.ndim))
        return P(dp, *([None] * (leaf.ndim - 1)))

    return tree.map(spec_for, batch)


def client_flat_specs(sizes, mesh, axes=("data", "model"), align=1):
    """PartitionSpecs for the (1, C, n_l)-flattened per-client update
    leaves of the sharded robust-aggregation path
    (``aggregation.aggregate_sharded``): the flattened param axis shards
    over ``axes`` when its size divides the combined axis extent, else the
    leaf stays replicated (small norm/bias leaves, counted once by the
    pipeline's all-reduce).  ``align`` additionally requires every shard to
    be a multiple of that many coordinates: the fused-dequant path passes
    its quant-block width so each rank's code shard carries exactly its own
    scale columns.  Returns (specs, sharded_flags)."""
    axes = tuple(axes)
    size = _axis_size(mesh, axes)
    specs, flags = [], []
    for n in sizes:
        if n >= size and n % (size * align) == 0:
            specs.append(P(None, None, axes))
            flags.append(True)
        else:
            specs.append(P(None, None, None))
            flags.append(False)
    return tuple(specs), tuple(flags)


def named(mesh, spec_tree):
    """A tree of ``NamedSharding``s from a tree of ``P``s (a ``P`` is a
    tuple, so it is taken whole, not walked)."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return type(spec_tree)(named(mesh, v) for v in spec_tree)


def map_shardings(fn, t):
    """``fn`` over the ``NamedSharding`` leaves of a tree (a
    ``NamedSharding`` is a tuple, so ``tree.map`` would walk into it)."""
    if isinstance(t, NamedSharding):
        return fn(t)
    if isinstance(t, dict):
        return {k: map_shardings(fn, v) for k, v in t.items()}
    return type(t)(map_shardings(fn, v) for v in t)
