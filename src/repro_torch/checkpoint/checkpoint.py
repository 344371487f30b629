"""Checkpointing: a tree <-> a directory of per-leaf ``.npy`` files with a
JSON manifest — port of ``repro/checkpoint/checkpoint.py``, in its on-disk
format: ``leaf_%05d.npy`` in the tree's flatten order and
``manifest.json`` with each leaf's name, file, dtype and shape, so a
checkpoint written by either package restores in the other.

  * bfloat16 has no numpy dtype here (the JAX package writes it through
    ``ml_dtypes``, which the card's machine does not have).  Such a leaf is
    saved as its 2-byte pattern, a numpy void ``|V2`` array (what
    ``ml_dtypes`` writes too) with ``"dtype": "bfloat16"`` in the
    manifest, and read back through the same view.
  * A ``torch.Generator`` leaf (a state's ``rng``) is saved as its
    ``get_state()`` bytes (``"dtype": "generator"``) and restored into the
    generator of ``like`` with ``set_state``.
  * ``None`` is an empty subtree, as in JAX: it has no file.
  * A DTensor leaf (a placed pod state, ``core/pod.py``) is saved gathered
    whole, in the same format: every rank gathers, the default group's
    rank 0 writes, and the ranks meet at a barrier.  ``restore`` places a
    leaf by its ``NamedSharding`` in ``sharding_tree`` (as the JAX
    package's ``device_put``s it), so a checkpoint saved on one mesh
    restores on another.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.sharding import dtensor


def _named_leaves(t, prefix=""):
    """(name, leaf) pairs in ``tree.leaves`` order, with JAX's path names
    (dict keys, sequence indices and NamedTuple fields joined by '/');
    ``None`` has none."""
    if t is None:
        return []
    if isinstance(t, dict):
        return [x for k in sorted(t)
                for x in _named_leaves(t[k], f"{prefix}{k}/")]
    if isinstance(t, (list, tuple)):
        names = getattr(t, "_fields", range(len(t)))
        return [x for n, v in zip(names, t)
                for x in _named_leaves(v, f"{prefix}{n}/")]
    return [(prefix.rstrip("/"), t)]


def _to_numpy(leaf):
    """(array, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy().copy(), "generator"
    if isinstance(leaf, torch.Tensor):
        t = dtensor.plain(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(path: str, t: Any, step: Optional[int] = None):
    leaves = _named_leaves(t)
    placed = any(isinstance(l, torch.Tensor) and dtensor.is_dtensor(l)
                 for _, l in leaves)
    arrays = [(name,) + _to_numpy(leaf) for name, leaf in leaves]
    if placed and dist.is_initialized() and dist.get_rank() != 0:
        dist.barrier()
        return
    os.makedirs(path, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype) in enumerate(arrays):
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(path, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if placed and dist.is_initialized():
        dist.barrier()


def _from_numpy(arr, m, like):
    """One saved leaf back into ``like``'s kind, on its device."""
    if m["dtype"] == "generator":
        if not isinstance(like, torch.Generator):
            raise TypeError(f"leaf {m['name']!r} is a generator state, the "
                            f"tree holds a {type(like).__name__}")
        like.set_state(torch.from_numpy(arr.astype(np.uint8)))
        return like
    if m["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if list(t.shape) != list(m["shape"]):
        raise ValueError(f"leaf {m['name']!r}: shape {list(t.shape)} != the "
                         f"manifest's {m['shape']}")
    if isinstance(like, torch.Tensor):
        dev = like.device_mesh.device_type if dtensor.is_dtensor(like) \
            else like.device
        return t.to(dev)
    return t


def restore(path: str, like: Any, sharding_tree: Any = None):
    """Restore into the structure of ``like``: each leaf on the device of
    ``like``'s leaf, a generator leaf into ``like``'s generator.  Where
    ``like``'s leaf is a DTensor (a placed state) the leaf is placed by its
    ``NamedSharding`` in ``sharding_tree`` (a tree like ``like``, which a
    placed ``like`` needs); the others stay plain."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = [leaf for _, leaf in _named_leaves(like)]
    if len(manifest["leaves"]) != len(flat_like):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"expected {len(flat_like)}")
    shs = (dtensor.sharding_leaves(sharding_tree)
           if sharding_tree is not None else [None] * len(flat_like))
    if len(shs) != len(flat_like):
        raise ValueError(f"{len(shs)} shardings for {len(flat_like)} leaves")
    out = []
    for m, l, sh in zip(manifest["leaves"], flat_like, shs):
        x = _from_numpy(np.load(os.path.join(path, m["file"])), m, l)
        if isinstance(l, torch.Tensor) and dtensor.is_dtensor(l):
            if sh is None:
                raise ValueError(f"leaf {m['name']!r} is placed in ``like``:"
                                 " restore it by a ``sharding_tree``")
            x = dtensor.to_layout(x, sh)
        out.append(x)
    it = iter(out)
    return tree.unflatten(like, [None if l is None else next(it)
                                 for l in tree.leaves(like)])


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_")]
    return max(steps) if steps else None


def save_step(root: str, step: int, t: Any):
    save(os.path.join(root, f"step_{step:08d}"), t, step)


def restore_latest(root: str, like: Any, sharding_tree: Any = None):
    step = latest_step(root)
    if step is None:
        return None, None
    return restore(os.path.join(root, f"step_{step:08d}"), like,
                   sharding_tree), step
