"""Host meshes over a ``torch.distributed`` process group — port of
``make_host_mesh`` in ``repro/launch/mesh.py``.

A ``Mesh`` lays the ranks of a process group out on a grid with JAX's axis
names ("data", "model"), row-major as ``jax.make_mesh`` lays out devices:
rank = data index * model + model index.  Beside it stands the same grid
as a ``torch.distributed`` ``DeviceMesh`` (dim names "data", "model"), on
which the pod step places its state as DTensors (``sharding/dtensor.py``),
and one sub-group a axis: ``Mesh.over(axes)`` is the mesh of the ranks that
share this rank's coordinates on the axes not named, whose collectives
(``sharding/collectives.py``) the aggregation over a part of the mesh
calls.

``make_production_mesh`` lays the production layout (16 x 16 ("data",
"model"), or 2 x 16 x 16 with a leading "pod" axis) out on a fake process
group of 256 or 512 ranks (``fake_group``), on which ``launch/dryrun.py``
counts the sharded step; this process is rank 0 of it.  Its
``DeviceMesh`` is a "cpu" one: a fake CUDA mesh cannot be built without a
card, and the dry-run's tensors are fake CPU tensors.

Nothing tells a program here of a cluster.  Where no group exists,
``host_mesh`` starts one of world size 1 itself, on a ``FileStore`` in a
temporary directory (no network): NCCL for a CUDA device, gloo for the
CPU.  A run of W processes starts its own group of W (each process gives
its rank) before it asks for the mesh.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    group: object                 # the process group (None: the default)
    rank: int                     # this rank's index in ``group``
    device_mesh: object = None    # the DeviceMesh of the grid (or None)
    groups: Tuple[object, ...] = ()     # one sub-group an axis

    @property
    def size(self):
        n = 1
        for s in self.shape:
            n *= s
        return n

    def coords(self):
        """This rank's index along each axis."""
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def index(self, axes):
        """This rank's linear index over ``axes`` (a name or a tuple of
        names, major first), as ``jax.lax.axis_index`` combines them."""
        axes = axes if isinstance(axes, tuple) else (axes,)
        c = dict(zip(self.axis_names, self.coords()))
        i = 0
        for a in axes:
            i = i * self.shape[self.axis_names.index(a)] + c[a]
        return i

    def over(self, axes):
        """The mesh of the ranks that share this rank's coordinates on the
        axes not in ``axes``: its group is that sub-group, its rank this
        rank's index over ``axes``.  ``axes`` spanning the mesh (in its
        order) give the mesh itself."""
        axes = tuple(axes if isinstance(axes, tuple) else (axes,))
        if axes == self.axis_names:
            return self
        extent = lambda a: self.shape[self.axis_names.index(a)]
        if all(extent(a) == 1 for a in self.axis_names if a not in axes):
            group = self.group          # the other axes are 1 wide
        elif len(axes) == 1:
            group = self.groups[self.axis_names.index(axes[0])]
        else:
            raise ValueError(f"axes {axes}: a sub-group is one axis of the "
                             f"mesh {self.axis_names} or all of them")
        return Mesh(axes, tuple(extent(a) for a in axes), group,
                    self.index(axes))


def start_group(device, world_size=1, rank=0, store_dir=None):
    """Starts the default process group on a ``FileStore`` in ``store_dir``
    (a new temporary directory if None): NCCL for a CUDA ``device`` (which
    becomes the current device), gloo for the CPU.  Returns the directory."""
    device = torch.device(device)
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro_torch_pg_")
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", store=store, world_size=world_size,
                                rank=rank, device_id=device)
    else:
        dist.init_process_group("gloo", store=store, world_size=world_size,
                                rank=rank)
    return store_dir


def make_host_mesh(data: int = 1, model: int = 1, *, group=None):
    """A ("data", "model") mesh over the ranks of ``group`` (default: the
    default group, which must exist), with its ``DeviceMesh`` and one
    sub-group an axis.  ``data`` and ``model`` are clamped as JAX clamps
    them to the device count (``model = max(1, min(model, n // data))``);
    the mesh must then span the group."""
    n = dist.get_world_size(group)
    data = min(data, n)
    model = max(1, min(model, n // data))
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh does not span the "
                         f"{n} ranks of the group")
    if group is not None and model > 1:
        raise ValueError("a model axis needs the default group")
    rank = dist.get_rank(group)
    device_mesh, groups = None, ()
    if group is None:
        from torch.distributed.device_mesh import DeviceMesh
        dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = DeviceMesh(dev, torch.arange(n).reshape(data, model),
                                 mesh_dim_names=("data", "model"))
        groups = (device_mesh.get_group("data"),
                  device_mesh.get_group("model"))
    return Mesh(("data", "model"), (data, model), group, rank, device_mesh,
                groups)


@contextlib.contextmanager
def fake_group(world_size):
    """The default process group on the "fake" backend (``FakeStore``: no
    rank but this one exists, collectives move nothing), this process rank
    0 of ``world_size``; destroyed on exit.  Raises if a default group
    already exists: it never replaces or joins one."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the fake group "
                           "of the dry-run needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_grid_mesh(shape, axis_names, device="cpu"):
    """A mesh of ``shape`` over the whole default group, with its
    ``DeviceMesh`` on ``device`` and one sub-group an axis; ranks row-major,
    as ``jax.make_mesh`` lays out devices."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axis_names = tuple(shape), tuple(axis_names)
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh does not span the "
                         f"{dist.get_world_size()} ranks of the group")
    device_mesh = DeviceMesh(device, torch.arange(n).reshape(shape),
                             mesh_dim_names=axis_names)
    return Mesh(axis_names, shape, None, dist.get_rank(), device_mesh,
                tuple(device_mesh.get_group(a) for a in axis_names))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks ("data", "model"); ``multi_pod`` adds a leading
    2-wide "pod" axis (512 ranks).  The default group must be a fake group
    of that many ranks (``fake_group``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("make_production_mesh needs a fake default group "
                           "(launch.mesh.fake_group)")
    return make_grid_mesh(shape, axes)


@contextlib.contextmanager
def host_mesh(data: int = 1, model: int = 1, *, device="cpu"):
    """``make_host_mesh`` over the default group, started at world size 1
    on ``device``'s backend where none exists, and destroyed on exit if it
    was started here."""
    own = not dist.is_initialized()
    store_dir = start_group(device) if own else None
    try:
        yield make_host_mesh(data, model)
    finally:
        if own:
            dist.destroy_process_group()
            shutil.rmtree(store_dir, ignore_errors=True)
