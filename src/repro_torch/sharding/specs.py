"""Partition specs of the pod path: the port of ``repro/sharding/specs.py``,
name-based rules from parameter paths to ``P``s over the ("data", "model")
(+ optional "pod") mesh.

Sharding scheme (FSDP x TP + the federation's semantics):
  * batch            -> ("pod", "data") axes (clients are data-axis groups)
  * weights          -> 2D: one dim over "model" (tensor / expert parallel),
    the other over "data" (FSDP; the step gathers each leaf over "data"
    where it is read)
  * embeddings       -> vocab over "model", d_model over "data"
  * KV caches        -> batch over data, sequence over "model"
  * small / recurrent leaves (norms, gates, biases, the sLSTM recurrence)
    replicated

Layer params carry a leading stacked n_units axis -> their specs get a
leading None.  A sharded dim that does not divide its axis extent is
replicated (never split unevenly).

A mesh here (``launch/mesh.py``) is a grid of the ranks of one
``torch.distributed`` process group, with JAX's axis names; anything with
``axis_names`` and a ``shape`` (a tuple in axis order, or a dict by name)
will do for the spec functions.  ``P`` is JAX's ``PartitionSpec`` (a tuple:
per dimension ``None`` or the mesh axes it is split over), ``NamedSharding``
a spec on a mesh.  ``placements`` turns a ``P`` into DTensor placements on
the mesh's ``DeviceMesh``, which is how the pod step holds its state
(``core/pod.py``); ``NamedSharding.local`` cuts this rank's piece out of a
whole tensor for the batch staging, and the sharded aggregation's
collectives are written out (``sharding/collectives.py``).
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

import torch

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


def _extent(mesh, name):
    if isinstance(mesh.shape, dict):
        return mesh.shape[name]
    return mesh.shape[list(mesh.axis_names).index(name)]


def _axis_size(mesh, axis):
    r = 1
    for a in _axes(axis):
        r *= _extent(mesh, a)
    return r


def _dp_axes(mesh):
    names = mesh.axis_names
    return ("pod", "data") if "pod" in names else ("data",)


# ---------------------------------------------------------------- params --

# (regex over the param path, spec for the *unstacked* leaf)
_RULES = [
    # embeddings / head
    (r"(^|/)embed$", lambda nd: P("model", "data")),
    (r"(^|/)lm_head$", lambda nd: P("data", "model")),
    # attention
    (r"attn/w[qkv]$|xattn/w[qkv]$", lambda nd: P("data", "model")),
    (r"attn/wo$|xattn/wo$", lambda nd: P("model", "data")),
    (r"attn/b[qkv]$|xattn/b[qkv]$", lambda nd: P("model")),
    # dense mlp
    (r"mlp/w[gu]$", lambda nd: P("data", "model")),
    (r"mlp/wo$", lambda nd: P("model", "data")),
    # moe (expert-parallel over "model", FSDP over "data")
    (r"moe/router$", lambda nd: P(None, None)),
    (r"moe/w[guo]$", lambda nd: P("model", "data", None)),
    # mamba (d_inner over "model")
    (r"mamba/in_proj$", lambda nd: P("data", "model")),
    (r"mamba/conv_w$", lambda nd: P(None, "model")),
    (r"mamba/conv_b$|mamba/dt_bias$|mamba/D$", lambda nd: P("model")),
    (r"mamba/x_proj$|mamba/out_proj$|mamba/A_log$",
     lambda nd: P("model", None)),
    (r"mamba/dt_proj$", lambda nd: P(None, "model")),
    # mlstm (d_inner over "model"; tiny gate/norm leaves replicated)
    (r"mlstm/up$", lambda nd: P("data", "model")),
    (r"mlstm/w[qkv]$", lambda nd: P("data", "model")),
    (r"mlstm/conv_w$", lambda nd: P(None, "model")),
    (r"mlstm/conv_b$|mlstm/gn$", lambda nd: P("model")),
    (r"mlstm/down$", lambda nd: P("model", "data")),
    # slstm
    (r"slstm/w$", lambda nd: P("data", "model")),
    (r"slstm/up_[gu]$", lambda nd: P("data", "model")),
    (r"slstm/down$", lambda nd: P("model", "data")),
]


def _walk(fn, t, path=()):
    """``fn(path, leaf)`` over a tree's leaves, with JAX's key path: a dict
    key, a sequence index, or ``.field`` of a NamedTuple; ``None`` is an
    empty subtree and stays ``None``."""
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _walk(fn, t[k], path + (str(k),)) for k in sorted(t)}
    if isinstance(t, (list, tuple)) and not isinstance(t, P):
        names = ([f".{f}" for f in t._fields] if hasattr(t, "_fields")
                 else [str(i) for i in range(len(t))])
        return tree._rebuild(t, [_walk(fn, v, path + (n,))
                                 for n, v in zip(names, t)])
    return fn("/".join(path), t)


def _zip(fn, a, b):
    """``fn(path, a_leaf, b_leaf)`` over two trees of one structure (their
    leaves may be ``P``s)."""
    flat = []
    _walk(lambda p, l: flat.append(l), b)
    it = iter(flat)
    return _walk(lambda p, s: fn(p, s, next(it)), a)


def _ndim(leaf):
    return leaf.dim() if isinstance(leaf, torch.Tensor) else (
        len(leaf.shape) if hasattr(leaf, "shape") else 0)


def _divides(parts, leaf, mesh):
    if mesh is None:
        return parts
    return tuple(a if (a is None or leaf.shape[i] % _axis_size(mesh, a) == 0)
                 else None for i, a in enumerate(parts))


def param_specs(params: Any, *, mesh=None) -> Any:
    """``P`` tree matching ``params`` (any tree holding a params subtree:
    optimizer states and a ``PodState`` too, since the rules match path
    suffixes).  With ``mesh``, a sharded dim that does not divide its axis
    extent is replicated.  A leaf that is not a tensor (a generator) gets
    ``P()``."""

    def spec_for(s, leaf):
        nd = _ndim(leaf)
        stacked = re.search(r"(^|/)layers/", s) is not None
        for pat, fn in _RULES:
            if re.search(pat, s):
                parts = tuple(fn(nd - (1 if stacked else 0)))
                if stacked:
                    parts = (None,) + parts
                parts = parts[:nd] + (None,) * (nd - len(parts[:nd]))
                return P(*_divides(parts, leaf, mesh))
        return P(*([None] * nd))        # replicate by default

    return _walk(spec_for, params)


def _div_guard(spec, leaf, mesh):
    return P(*_divides(tuple(spec)[:_ndim(leaf)], leaf, mesh))


def param_specs_moe_ff(params: Any, *, mesh=None) -> Any:
    """The MoE-aware FSDP variant: expert weights keep expert parallelism
    over "model" but put the FSDP ("data") leg on the FFN dimension."""
    full = param_specs(params, mesh=mesh)

    def fix(s, spec, leaf):
        if re.search(r"moe/w[gu]$", s):
            return _div_guard(P(None, "model", None, "data"), leaf, mesh)
        if re.search(r"moe/wo$", s):
            return _div_guard(P(None, "model", "data", None), leaf, mesh)
        return spec

    return _zip(fix, full, params)


def param_specs_tp(params: Any, *, mesh=None) -> Any:
    """The tensor-parallel-only variant: the FSDP ("data") leg dropped
    (ZeRO-1's compute layout, and the per-client grads' layout)."""
    full = param_specs(params, mesh=mesh)
    return _walk(lambda s, spec: P(*[None if a == "data" else a
                                     for a in spec]), full)


def param_specs_zero1_moe(params: Any, *, mesh=None) -> Any:
    """ZeRO-1's compute layout for MoE archs: dense and attention weights
    TP-only, expert weights kept sharded (model x ff-over-data)."""
    moe = param_specs_moe_ff(params, mesh=mesh)
    return _zip(lambda s, tp, m: m if re.search(r"moe/w[guo]$", s) else tp,
                param_specs_tp(params, mesh=mesh), moe)


# ----------------------------------------------------------- batch/cache --

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


def cache_specs(cache: Any, mesh) -> Any:
    """KV caches: batch over data axes, sequence dim over "model".  Leaf
    shapes (stacked, units first): kv (U, B, L, Hkv, dh) -> P(None, dp,
    "model", None, None); ssm / xlstm states (U, B, ...) -> P(None, dp,
    None...); scalars replicated."""
    dp = _dp_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    msize = _extent(mesh, "model")

    def spec_for(s, leaf):
        name = s.rsplit("/", 1)[-1]
        nd = _ndim(leaf)
        if nd == 0:
            return P()
        b_ok = nd >= 2 and leaf.shape[1] % dp_size == 0
        bspec = dp if b_ok else None
        if name in ("k", "v", "ck", "cv") and nd >= 5:
            s_ok = leaf.shape[2] % msize == 0
            return P(None, bspec, "model" if s_ok else None,
                     *([None] * (nd - 3)))
        if nd >= 2:
            return P(None, bspec, *([None] * (nd - 2)))
        return P(*([None] * nd))

    return _walk(spec_for, cache)


# --------------------------------------------------------- client layout --

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


def client_flat_shardings(sizes, mesh, axes=("data", "model")):
    """``client_flat_specs`` as ``NamedSharding``s.  Returns (shardings,
    sharded_flags)."""
    specs, flags = client_flat_specs(sizes, mesh, axes)
    return tuple(NamedSharding(mesh, s) for s in specs), flags


def client_store_specs(store, mesh, axes=("data", "model")) -> Any:
    """PartitionSpecs for the population-scale ClientStore: every (M, ...)
    column shards its population axis over the combined ``axes`` extent
    when M divides it, else it is replicated."""
    axes = tuple(axes)
    size = _axis_size(mesh, axes)

    def spec_for(s, leaf):
        nd = _ndim(leaf)
        if nd == 0 or leaf.shape[0] % size != 0:
            return P(*([None] * nd))
        return P(axes, *([None] * (nd - 1)))

    return _walk(spec_for, store)


# -------------------------------------------------------------- DTensor --

def placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``'s ``DeviceMesh``: one a
    mesh dim, ``Shard(d)`` where tensor dim d is split over that axis, else
    ``Replicate()``.  A dim split over a tuple of axes gets ``Shard(d)`` on
    each, major first, which is JAX's order only when the tuple follows the
    mesh's axis order (else ``ValueError``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.axis_names]
    for d, a in enumerate(spec):
        if a is None:
            continue
        idx = [mesh.axis_names.index(n) for n in _axes(a)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes of dim {d} are not in the "
                             f"mesh's order {mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def named(mesh, spec_tree):
    """A tree of ``NamedSharding``s from a tree of ``P``s (a ``P`` is a
    tuple, so it is taken whole, not walked)."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    return tree._rebuild(spec_tree, [named(mesh, v) for v in spec_tree])


def map_shardings(fn, t):
    """``fn`` over the ``NamedSharding`` leaves of a tree (a
    ``NamedSharding`` is a tuple, so ``tree.map`` would walk into it)."""
    if isinstance(t, NamedSharding):
        return fn(t)
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: map_shardings(fn, v) for k, v in t.items()}
    return tree._rebuild(t, [map_shardings(fn, v) for v in t])
