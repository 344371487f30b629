"""Host meshes over a ``torch.distributed`` process group — port of
``make_host_mesh`` in ``repro/launch/mesh.py``.

A ``Mesh`` lays the ranks of a process group out on a grid with JAX's axis
names ("data", "model"), row-major as ``jax.make_mesh`` lays out devices:
rank = data index * model + model index.  Only the data axis may be wider
than 1: tensor parallelism (a "model" axis) is ROADMAP queue 1 item g',
and so is ``make_production_mesh``, the TPU pod's 16 x 16 layout.

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
    rank: int

    @property
    def size(self):
        return self.shape[0] * self.shape[1]

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
    default group, which must exist).  ``data`` is clamped to the group's
    size as JAX clamps it to the device count; the mesh must then span the
    group."""
    if model > 1:
        raise NotImplementedError(
            "a model axis (tensor parallelism) is ROADMAP queue 1 item g'")
    n = dist.get_world_size(group)
    data = min(data, n)
    if data * model != n:
        raise ValueError(f"a {data} x {model} mesh does not span the "
                         f"{n} ranks of the group")
    return Mesh(("data", "model"), (data, model), group,
                dist.get_rank(group))


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
