"""The pod step's state as DTensors (``torch.distributed.tensor``): the
counterpart of GSPMD's placed arrays.

A state leaf placed by a ``P`` (``specs.placements``) is a ``DTensor`` on
the mesh's ``DeviceMesh``; an op on DTensors inserts the collectives its
sharding needs (the all-gather of an FSDP leg, the reduce-scatter of a
gradient, the all-reduce of a partial sum), as GSPMD inserts them around
the JAX package's jitted step.  The models are written on plain tensors
and run on DTensors unchanged, except around the ops that have no DTensor
sharding strategy: there ``local_op`` redistributes explicitly to
``Replicate`` (keeping the batch rows' split over the data axes where the
op is row-local), runs the op on the local tensors, and wraps its outputs
back, as GSPMD all-gathers around an op it cannot partition.  Each such
place is listed in ROADMAP §3.  Nothing here catches an error: an op
without a strategy outside those places raises.

On plain tensors every function here is the identity (``local_op`` calls
the op), so the unsharded step runs the same code.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import tree

DP_AXES = ("pod", "data")


def is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _any_dtensor(xs):
    return next((x for x in xs if isinstance(x, torch.Tensor)
                 and is_dtensor(x)), None)


@contextlib.contextmanager
def mixing(on=True):
    """Lets plain tensors (the models' device fills and index ranges) enter
    ops with DTensors as replicated operands; a no-op when ``on`` is
    false."""
    if not on:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def _row_placements(x):
    """``x``'s placements with the batch rows' split (``Shard(0)`` on a data
    axis) kept and everything else ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    names = x.device_mesh.mesh_dim_names or ()
    return [p if (isinstance(p, Shard) and p.dim == 0 and i < len(names)
                  and names[i] in DP_AXES) else Replicate()
            for i, p in enumerate(x.placements)]


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the grad contiguous: DTensor's
    backward of a redistribution views the grad of a local tensor, which
    an einsum's backward leaves strided."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_op(fn, *args, rows=0, heads=(), out_heads=None):
    """``fn(*args)`` on plain tensors, for an op with no DTensor sharding
    strategy.  The first ``rows`` args are batch-row tensors: they keep
    their split over the data axes (``fn`` must then be row-local).
    ``heads`` gives the head dim of each of the first ``len(heads)`` args:
    where the first arg's head dim is split over another axis, each of them
    is split alike on its own head dim (``fn`` must then be local to a
    head).  Every other split is redistributed to ``Replicate``; ``fn``
    runs on the local tensors, and its tensor outputs come back as
    DTensors placed as the first arg was (``Replicate`` if there are no
    row args), or, with ``out_heads`` (the head dim of each output), split
    on their own head dims.  Without a DTensor among ``args`` it is
    ``fn(*args)``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ref = _any_dtensor(args)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    full = [Replicate()] * mesh.ndim
    first = _any_dtensor(args[:rows])
    row_pl = _row_placements(first) if first is not None else full
    lead = args[0] if heads else None
    split = ([i for i, p in enumerate(lead.placements)
              if p == Shard(heads[0]) and row_pl[i] == Replicate()]
             if isinstance(lead, torch.Tensor) and is_dtensor(lead) else [])

    def target(i):
        if i >= rows:
            return full
        pl = list(row_pl)
        if i < len(heads):
            for m in split:
                pl[m] = Shard(heads[i])
        return pl

    out_pl = target(0) if rows else full
    # the mesh dims the computation is split over: there the grad of an
    # input that every rank reads whole is a partial sum
    comp = {i for i, p in enumerate(row_pl) if isinstance(p, Shard)}
    comp.update(split)

    def grad_pl(pl):
        return [p if isinstance(p, Shard) else
                Partial() if i in comp else Replicate()
                for i, p in enumerate(pl)]

    loc = []
    for i, a in enumerate(args):
        pl = target(i)
        if isinstance(a, torch.Tensor) and is_dtensor(a):
            a = _ContiguousGrad.apply(redistribute(a, mesh, pl).to_local(
                grad_placements=grad_pl(pl)))
        elif isinstance(a, torch.Tensor) and pl != full:
            a = _cut(a, mesh, pl).to_local()
        loc.append(a)
    out = fn(*loc)

    def wrap(o, h=None):
        pl = out_pl
        if h is not None:
            pl = list(row_pl)
            for m in split:
                pl[m] = Shard(h)
        if isinstance(o, torch.Tensor):     # contiguous: DTensor views it
            return DTensor.from_local(o.contiguous(), mesh, pl,
                                      run_check=False)
        return o

    if isinstance(out, tuple):
        hs = out_heads or (None,) * len(out)
        return tuple(wrap(o, h) for o, h in zip(out, hs))
    return wrap(out, out_heads[0] if out_heads else None)


def split_count(x, dim):
    """The number of pieces ``x``'s dim ``dim`` is split into over the mesh
    (the product of the sizes of the mesh dims that shard it); 1 for a plain
    ``x``."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return 1
    from torch.distributed.tensor import Shard
    dim %= x.dim()
    n = 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            n *= x.device_mesh.size(i)
    return n


def piece(mesh, placements, dim, length):
    """(offset, size) of this rank's piece of a dim of ``length`` placed
    ``Shard(dim)`` on the mesh dims of ``placements`` that say so (an even
    split, nested in mesh-dim order as DTensor nests it)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    off, size = 0, length
    for i, p in enumerate(placements):
        if p == Shard(dim):
            size //= mesh.size(i)
            off += coord[i] * size
    return off, size


def whole_local(x, split=()):
    """``x`` gathered whole over every mesh dim, as its plain local tensor
    (``x`` itself if plain).  Its grad is a partial sum over the mesh dims
    in ``split``, where each rank reads its own part of it, and whole
    elsewhere (the grad comes back to ``x``'s placements by a
    reduce-scatter or a local slice)."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Partial, Replicate
    mesh = x.device_mesh
    full = [Replicate()] * mesh.ndim
    return redistribute(x, mesh, full).to_local(grad_placements=[
        Partial() if i in split else Replicate() for i in range(mesh.ndim)])


class _SumPartial(torch.autograd.Function):
    """Each rank's local part of a sum over the mesh dims in ``split``,
    reduced into ``target``'s placements (a reduce-scatter onto a split
    dim, an all-reduce onto a whole one); the grad of every part is the
    whole grad."""

    @staticmethod
    def forward(ctx, part, mesh, split, target):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        ctx.mesh, ctx.target = mesh, target
        pl = [Partial() if i in split else Replicate()
              for i in range(mesh.ndim)]
        x = DTensor.from_local(part, mesh, pl, run_check=False)
        return redistribute(x, mesh, target).to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate
        mesh = ctx.mesh
        x = DTensor.from_local(g.contiguous(), mesh, ctx.target,
                               run_check=False)
        return (redistribute(x, mesh, [Replicate()] * mesh.ndim).to_local(),
                None, None, None)


def sum_partial(part, mesh, split, target):
    """The DTensor placed by ``target`` whose value is the sum over the
    mesh dims in ``split`` of each rank's plain ``part`` (the same on the
    other dims): the collective of GSPMD's partial sum, deterministic
    (NCCL's reduce-scatter and all-reduce, a relabel on dims of one
    rank)."""
    from torch.distributed.tensor import DTensor
    out = _SumPartial.apply(part, mesh, frozenset(split), list(target))
    return DTensor.from_local(out, mesh, target, run_check=False)


def pad_units(x, dim, units, unit, index):
    """``x``'s dim ``dim``, which holds ``units`` units of ``unit`` entries
    (heads), read as the ``len(index)`` units ``index`` names: unit j of the
    result is ``x``'s unit ``index[j]``, or zeros where ``index[j] < 0``.
    ``index`` pads a head split that does not divide, as GSPMD pads it
    (zero heads on the last ranks), and can repeat a unit (a kv head read
    once for each of its q heads).  On a DTensor whose dim is split over
    the mesh the result is split evenly (``len(index)`` a multiple of the
    split's rank count), each rank reading only its own units: its piece
    of ``x`` is gathered over the split first; a dim that is whole stays
    whole.  A pad unit takes no part in any result (zero in, its grads
    dropped); a repeated unit's grads add up.  ``x`` itself where
    ``index`` is None.

    The models read the projection weights so (``wq`` / ``wk`` / ``wv``
    columns, ``wo`` rows): the heads come out padded and split evenly, the
    stored params and their layouts stay as they are."""
    if index is None:
        return x
    dim %= x.dim()

    def take(t, lo, n):
        # units [lo, lo + n) of the result, from t (the whole dim)
        at = [units if i < 0 else i for i in index[lo:lo + n]]
        t = t.unflatten(dim, (units, unit))
        zero = torch.zeros_like(t.narrow(dim, 0, 1))
        t = torch.cat([t, zero], dim).index_select(
            dim, torch.tensor(at, device=t.device))
        return t.flatten(dim, dim + 1)

    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return take(x, 0, len(index))
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    # the dim whole (a partial sum reduced); the rest as it is
    whole = [p if isinstance(p, Shard) and i not in split else Replicate()
             for i, p in enumerate(x.placements)]
    loc = redistribute(x, mesh, whole).to_local(grad_placements=[
        Partial() if i in split else p for i, p in enumerate(whole)])
    lo, n = piece(mesh, x.placements, dim, len(index))
    mine = take(loc, lo, n).contiguous()
    shape = list(x.shape)
    shape[dim] = len(index) * unit
    pl = [p if i in split else q for i, (p, q) in enumerate(zip(
        x.placements, whole))]
    return DTensor.from_local(mine, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def unpad_units(x, dim, units, unit, index):
    """The units ``index`` names of ``x``'s dim ``dim`` (``units`` units of
    ``unit``), whole: on a DTensor gathered over every mesh dim but the
    batch rows' data split (a ``local_op``).  ``x`` itself where ``index``
    is None."""
    if index is None:
        return x
    dim %= x.dim()

    def take(t):
        at = torch.tensor(list(index), device=t.device)
        return t.unflatten(dim, (units, unit)).index_select(
            dim, at).flatten(dim, dim + 1)

    return local_op(take, x, rows=1)


def pad_index(units, to):
    """``pad_units``' index of ``units`` units padded with zero units to
    ``to``; None where there is nothing to pad."""
    if to == units:
        return None
    return list(range(units)) + [-1] * (to - units)


def _contiguous_stride(shape):
    stride, s = [], 1
    for n in reversed(shape):
        stride.append(s)
        s *= n
    return tuple(reversed(stride))


class _GradLike(torch.autograd.Function):
    """The identity on a DTensor, whose backward brings the grad to the
    forward's placements (a partial sum reduced): the all-reduce in the
    backward of a tensor-parallel block's input, as in Megatron's and
    GSPMD's partitioning."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.pl = x.device_mesh, list(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g):
            return redistribute(g, ctx.mesh, ctx.pl)
        return g


def residual(x):
    """The residual stream at a block boundary in one layout: the batch
    rows split over the data axes (where they divide), whole over every
    other mesh dim (a partial sum reduced, a split gathered), and its grad
    brought to that layout too.  Without it a block's layout, and so its
    collectives and flops, would follow the layout the block before it
    left, and a layer's cost would depend on its neighbours; and the grad
    of a tensor-parallel block's input (a partial sum over "model") would
    reach the block before it unreduced, where DTensor would rather gather
    a weight whole than reduce the grad, and run that block's backward on
    every rank's partial sum.  A plain ``x``, and a DTensor on a mesh of one
    rank (where every layout is the same local tensor and a redistribution
    costs only DTensor's host dispatch), is returned as it is."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    if mesh.size() == 1:
        return x
    data = [i for i, n in enumerate(mesh.mesh_dim_names or ())
            if n in DP_AXES]
    n = 1
    for i in data:
        n *= mesh.size(i)
    row = Shard(0) if x.shape[0] % n == 0 else Replicate()
    x = redistribute(x, mesh, [row if i in data else Replicate()
                               for i in range(mesh.ndim)])
    return _GradLike.apply(x) if x.requires_grad else x


def copy_(dst, src):
    """``dst.copy_(src)`` with ``dst``'s placements kept: each rank writes
    its own piece (DTensor's own in-place ops replace the placements of a
    tensor split on a written dim and leave its local tensor as it was).
    Returns ``dst``."""
    if not is_dtensor(dst):
        dst.copy_(src)
        return dst
    mesh, pl = dst.device_mesh, dst.placements
    dst.to_local().copy_((redistribute(src, mesh, pl) if is_dtensor(src)
                          else _cut(src, mesh, pl)).to_local())
    return dst


def write_run_(dst, dim, start, src):
    """A cache write: ``dst``'s slots ``(start + t) mod n`` on dim ``dim``
    (``n`` its length there) set to ``src``'s slice ``t``, for ``t`` below
    ``src.shape[dim]`` (at most ``n``), in place.  On a plain ``dst`` it is
    that ``index_copy_``.  On a placed one each rank writes only the slots
    that fall in its own piece, with no collective: ``src`` is laid out as
    ``dst`` but whole on ``dim``, and in steps of this rank's piece length
    ``m`` the run's slots land on the distinct local offsets ``(slot - lo)
    mod m``; a slot outside the piece writes back the value it finds
    there, so the write is exact.  Returns ``dst``."""
    from torch.distributed.tensor import Replicate, Shard
    n, T = dst.shape[dim], src.shape[dim]
    if not is_dtensor(dst):
        idx = (start + torch.arange(T, device=src.device)) % n
        return dst.index_copy_(dim, idx, src)
    pl = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    src = (redistribute(src, dst.device_mesh, pl) if is_dtensor(src)
           else _cut(src, dst.device_mesh, pl)).to_local()
    start = local(start)
    loc = dst.to_local()
    lo, m = piece(dst.device_mesh, dst.placements, dim, dst.shape[dim])
    shape = [1] * loc.dim()
    for c in range(0, T, m):
        run = src.narrow(dim, c, min(m, T - c))
        slot = (start + c + torch.arange(run.shape[dim],
                                         device=loc.device)) % n
        at = (slot - lo) % m
        shape[dim] = run.shape[dim]
        mine = ((slot >= lo) & (slot < lo + m)).reshape(shape)
        loc.index_copy_(dim, at, torch.where(mine, run,
                                             loc.index_select(dim, at)))
    return dst


def over_data(x, dim=None):
    """``x`` with its split over the data axes set to ``Shard(dim)``
    (``None``: whole over them) and its other mesh dims as they are: a
    weight gathered over the data axes where it is read (FSDP's
    all-gather; its grad comes back by a reduce-scatter), or a replicated
    activation cut to this rank's block (a local slice).  Where ``dim``
    does not divide the data extent ``x`` stays whole over them.  A plain
    ``x`` is returned as it is."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    data = [i for i, n in enumerate(mesh.mesh_dim_names or ())
            if n in DP_AXES]
    n = 1
    for i in data:
        n *= mesh.size(i)
    pl = list(x.placements)
    for i in data:
        pl[i] = (Shard(dim) if dim is not None and x.shape[dim] % n == 0
                 else Replicate())
    return redistribute(x, mesh, pl)


def sharding_leaves(t):
    """The ``NamedSharding`` leaves of a tree in ``tree.leaves`` order
    (dict keys sorted); ``None`` has none."""
    from repro_torch.sharding import specs
    if t is None:
        return []
    if isinstance(t, specs.NamedSharding):
        return [t]
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in sharding_leaves(t[k])]
    return [x for v in t for x in sharding_leaves(v)]


def to_layout(x, sh):
    """``x`` placed by the ``NamedSharding`` ``sh`` on its mesh's
    ``DeviceMesh``: a DTensor is redistributed (the collectives between
    the two layouts), a plain tensor (the same whole tensor on every rank)
    is cut to this rank's piece with no communication."""
    from repro_torch.sharding import specs

    pl = specs.placements(sh.spec, sh.mesh)
    if is_dtensor(x):
        return redistribute(x, sh.mesh.device_mesh, pl)
    return _cut(x, sh.mesh.device_mesh, pl)


def _cut(x, device_mesh, pl):
    """The whole plain ``x`` (the same on every rank) as a DTensor placed by
    ``pl``: this rank's piece, with no communication (and on a mesh of one
    rank, no copy)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if device_mesh.size() == 1:
        return DTensor.from_local(x, device_mesh, pl, run_check=False)
    return distribute_tensor(x, device_mesh, pl, src_data_rank=None)


def redistribute(x, device_mesh, pl):
    """``x.redistribute(device_mesh, pl)``; where the placements differ
    only on mesh dims of one rank (the same local data), the local tensor
    relabelled, with no collective and no copy."""
    from torch.distributed.tensor import DTensor
    if x.device_mesh == device_mesh and all(
            a == b or device_mesh.size(i) == 1
            for i, (a, b) in enumerate(zip(x.placements, pl))):
        if tuple(x.placements) == tuple(pl):
            return x
        return DTensor.from_local(x.to_local(), device_mesh, pl,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return x.redistribute(device_mesh, pl)


def place(t, shardings):
    """Each tensor leaf of ``t`` with at least one dim as a DTensor placed by
    its ``NamedSharding`` in ``shardings`` (``to_layout``).  0-d leaves
    (counters), non-tensor leaves (a generator) and ``None`` stay as they
    are."""
    shs = sharding_leaves(shardings)
    leaves = [l for l in tree.leaves(t) if l is not None]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(shs)} shardings for {len(leaves)} leaves")
    it = iter(shs)

    def one(x):
        if x is None:
            return None
        sh = next(it)
        if isinstance(x, torch.Tensor) and x.dim() > 0:
            return to_layout(x, sh)
        return x

    return tree.unflatten(t, [one(x) for x in tree.leaves(t)])


def placed_like(t, like):
    """Each tensor leaf of ``t`` (whole, the same on every rank) placed as
    ``like``'s DTensor leaf; a leaf whose ``like`` is plain stays."""
    def one(x, l):
        if isinstance(l, torch.Tensor) and is_dtensor(l) and not is_dtensor(x):
            return _cut(x, l.device_mesh, l.placements)
        return x

    return tree.unflatten(t, [one(x, l) for x, l in zip(tree.leaves(t),
                                                        tree.leaves(like))])


def local(x):
    """A DTensor's local tensor; ``x`` itself if it is plain."""
    if isinstance(x, torch.Tensor) and is_dtensor(x):
        return x.to_local()
    return x


def model_split(q):
    """The dim a leaf of the per-client compute copy (a DTensor on the
    "model" axis's one-dim sub-mesh, or plain) is split on over that axis,
    or ``None`` where it is whole."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(q):
        return None
    p = q.placements[0]
    return p.dim if isinstance(p, Shard) else None


def from_model_piece(o, q, p):
    """``o``, this rank's piece over "model" of a leaf laid out as the
    compute copy's leaf ``q`` and whole over the data axes, placed as the
    param ``p`` (its data split a local slice, no communication); ``o``
    itself where ``p`` is plain."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(p):
        return o
    mesh = p.device_mesh
    over_model = q.placements[0] if is_dtensor(q) else Replicate()
    pl = [Replicate() if n in DP_AXES else over_model
          for n in mesh.mesh_dim_names]
    x = DTensor.from_local(o, mesh, pl, run_check=False, shape=p.shape,
                           stride=p.stride())
    return redistribute(x, mesh, p.placements)


def whole(t):
    """Each DTensor leaf gathered whole on every rank (``full_tensor``; on
    a mesh of one rank its local tensor, with no copy); other leaves as
    they are."""
    def one(x):
        if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
            return x
        if x.device_mesh.size() == 1:
            return x.to_local()
        return x.full_tensor()

    return tree.map(one, t)


def plain(x):
    """A replicated DTensor's local tensor (a metric); ``x`` itself if it is
    plain."""
    if isinstance(x, torch.Tensor) and is_dtensor(x):
        return x.full_tensor()
    return x
