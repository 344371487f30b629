"""Roofline terms of a counted step (port of ``repro/launch/roofline.py``).

  compute term    = flops / peak FLOP/s               (per chip)
  memory term     = bytes accessed / HBM bandwidth    (per chip)
  collective term = sum(collective bytes x ring factor) / link bandwidth

The reference reads flops and bytes from XLA's ``cost_analysis()`` of the
partitioned module and collective bytes from its HLO text.  The port has
no compiled module: ``CostCounter`` counts the same three quantities from
the aten ops one rank runs (``launch/dryrun.py`` runs the step on fake
tensors over a fake process group, so nothing is allocated or moved).
The result keeps the reference's keys, ``hlo_flops`` and ``hlo_bytes``
too, so the two packages' JSON lines read side by side; here those are
aten counts, not HLO ones.  All-reduce keeps its 2x ring factor
(reduce-scatter + all-gather phases), the other kinds 1x.

The constants are the NVIDIA H100 SXM's (NVIDIA H100 Tensor Core GPU
datasheet): dense bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4's
900 GB/s total taken as 450e9 B/s in one direction.  ``CARD`` is what
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` printed
on the card the port is measured on.  The 16 x 16 production layout spans
256 GPUs, so its 16-wide "model" axis crosses two 8-GPU NVLink nodes: over
that axis the collective term is a lower bound.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree

# NVIDIA H100 SXM (datasheet); the card: NVIDIA H100 80GB HBM3, 700.00 W
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s
ICI_BW = 450e9                # B/s, NVLink 4, one direction (900 GB/s total)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def roofline(cost: dict, coll_bytes: Dict[str, int]) -> dict:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = sum(v * (2 if k == "all-reduce" else 1)
                 for k, v in coll_bytes.items())
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = byts / HBM_BW
    t_coll = cbytes / ICI_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dom = max(terms, key=terms.get)
    return {
        **terms,
        "hlo_flops": flops,
        "hlo_bytes": byts,
        "collective_bytes": cbytes,
        "collective_by_kind": dict(coll_bytes),
        "dominant": dom,
        "bound_s": max(terms.values()),
    }


def measured_wire_bytes(rows) -> dict:
    """The measured ``wire/bytes_up`` / ``wire/bytes_down`` telemetry
    gauges, totalled and per round, to sit beside the modeled terms.

    ``rows``: drained metric rows (dicts with ``obs/wire/...`` keys) or the
    path of a telemetry JSONL stream (its ``kind == "metrics"`` records).
    ``rounds`` counts the rows that carried the gauges (0 with telemetry
    counters off)."""
    if isinstance(rows, str):
        import json
        with open(rows) as f:
            rows = [r for r in (json.loads(l) for l in f if l.strip())
                    if r.get("kind") == "metrics"]
    up = [float(r["obs/wire/bytes_up"]) for r in rows
          if "obs/wire/bytes_up" in r]
    down = [float(r["obs/wire/bytes_down"]) for r in rows
            if "obs/wire/bytes_down" in r]
    n = max(len(up), len(down))
    return {
        "rounds": n,
        "bytes_up": sum(up),
        "bytes_down": sum(down),
        "bytes_up_per_round": sum(up) / n if n else 0.0,
        "bytes_down_per_round": sum(down) / n if n else 0.0,
    }


def count_params(params_struct) -> int:
    """Parameters of a params tree: the init on ``layers.SHAPE_ONLY``
    (meta leaves), or any tree of leaves with a ``shape``."""
    return sum(int(_prod(l.shape)) for l in tree.leaves(params_struct))


def active_params(cfg, n_params: int) -> int:
    """6*N_active*D MoE correction: expert FFN weights scale by top_k/E."""
    if not cfg.n_experts:
        return n_params
    cycle_moe = sum(1 for k in cfg.layers if k == "moe")
    expert_w = cycle_moe * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    return n_params - expert_w + expert_w * cfg.top_k // cfg.n_experts


def model_flops(cfg, n_params: int, shape, kind: str) -> float:
    """6*N*D (train) / 2*N*D (inference forward) reference FLOPs, global."""
    n_act = active_params(cfg, n_params)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * shape.global_batch


def _prod(t):
    r = 1
    for x in t:
        r *= x
    return r


# ------------------------------------------------------------- counting --

def _collective_kind(name):
    """The reference's collective name of a ``_c10d_functional`` / ``c10d``
    op (``None``: not a collective that moves data; ``wait_tensor`` is the
    completion half and is skipped, as the reference skips '-done')."""
    if "wait_tensor" in name:
        return None
    for key, kind in (("reduce_scatter", "reduce-scatter"),
                      ("all_gather", "all-gather"),
                      ("allgather", "all-gather"),
                      ("all_reduce", "all-reduce"),
                      ("allreduce", "all-reduce"),
                      ("all_to_all", "all-to-all"),
                      ("alltoall", "all-to-all"),
                      ("broadcast", "collective-permute"),
                      ("send", "collective-permute"),
                      ("recv", "collective-permute")):
        if key in name:
            return kind
    return None


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t):
    return t.numel() * t.element_size()


def _is_view(func):
    """A view or metadata op: its outputs alias an input without writing
    it, it only allocates (``empty*``), or it reads a tensor's metadata
    (``prim::device``, ``prim::layout``: no data moves)."""
    name = func.__name__ if hasattr(func, "__name__") else str(func)
    if name.startswith(("empty", "new_empty", "_unsafe_view", "detach",
                        "lift_fresh", "alias", "sym_", "is_")):
        return True
    if func.namespace == "prim":
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class _Propagation(threading.local):
    depth = 0


_PROPAGATING = _Propagation()


def _bookkeeping(fn, host=False):
    """``fn`` with the counter told that the ops it runs are DTensor's own
    bookkeeping, not this rank's computation; ``host``: a pure function of
    its (hashable) arguments that does index arithmetic on host tensors,
    run outside any fake mode and remembered while the counter is active
    (DTensor's planner asks for the same offsets thousands of times a step,
    each an arange and a ``tolist`` of a whole dim)."""
    memo = {}

    def marked(*args, **kwargs):
        key = (args, tuple(sorted(kwargs.items()))) if host else None
        if key is not None and key in memo:
            return memo[key]
        _PROPAGATING.depth += 1
        try:
            if host:
                from torch._subclasses.fake_tensor import \
                    unset_fake_temporarily
                with unset_fake_temporarily():
                    memo[key] = out = fn(*args, **kwargs)
                return out
            return fn(*args, **kwargs)
        finally:
            _PROPAGATING.depth -= 1

    return marked


@contextlib.contextmanager
def _hook_propagation():
    """Marks DTensor's own work while the counter is active: its shape
    propagation, which runs each op once more at its global shape (and
    only the first time a shape is seen, since the result is cached), and
    ``_StridedShard``'s shard offsets, index arithmetic on small host
    tensors (read to the host, so it runs outside the fake mode of a
    dry-run).  The counter leaves those calls out, so its count is this
    rank's and does not depend on the cache.  The methods are DTensor's
    own again on exit, and the remembered offsets are dropped."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    hooked = [(cls, name, getattr(cls, name), host) for cls, name, host in (
        (ShardingPropagator, "_propagate_tensor_meta_non_cached", False),
        (_StridedShard, "local_shard_size_and_offset", True))]
    for cls, name, inner, host in hooked:
        setattr(cls, name, _bookkeeping(inner, host))
    try:
        yield
    finally:
        for cls, name, inner, _ in hooked:
            setattr(cls, name, inner)


class CostCounter(TorchDispatchMode):
    """Counts, per chip, the aten ops this rank runs while it is active.

    * ``flops``: by ``torch.utils.flop_counter``'s formulas on the local
      tensors (a DTensor op is seen as the local ops it runs, so a matmul
      over sharded operands counts its local shard's product; the DTensor
      itself is passed on by returning ``NotImplemented``);
    * ``bytes``: each op's tensor inputs read once and outputs written
      once, views and allocations 0.  The count is unfused (every op
      reads and writes memory), so it runs above XLA's fused count;
    * ``collectives``: the bytes of each collective's output on this rank,
      by the reference's kind names (the shape ``parse_collectives`` reads
      off the result; a c10d op that returns only its Work, its output
      argument), ``wait_tensor`` skipped;
    * ``peak_bytes``: the largest total of live local storages while
      counting, starting from the tensors given to ``track`` (the
      arguments; ``argument_bytes``).  A storage is live until its last
      tensor is freed, so the figure follows autograd's saved tensors and
      the step's own frees.

    DTensor's own bookkeeping (its global-shape propagation) is left out,
    by hooks that stand only while the counter is active (see
    ``_hook_propagation``).  On real tensors it counts the same way, so a
    step counted on the card and its dry-run on fake tensors compare."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.by_op = {}
        self.live = 0
        self.peak_bytes = 0
        self.argument_bytes = 0
        self._storages = {}
        self._hooks = None

    # ---- memory ------------------------------------------------------
    def _add_storage(self, t):
        if _is_dtensor(t) or t.device.type == "meta":
            return 0
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return 0
        key = id(st)
        if key in self._storages:
            return 0
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        return n

    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def track(self, *trees):
        """Counts the local storages of ``trees`` (DTensor leaves by their
        local tensors) as live arguments; returns their bytes."""
        n = 0
        for t in trees:
            for x in tree.leaves(t):
                if isinstance(x, torch.Tensor):
                    n += self._add_storage(x.to_local() if _is_dtensor(x)
                                           else x)
        self.argument_bytes += n
        return n

    def costs(self):
        """(cost dict with the reference's keys, collective bytes by
        kind)."""
        return ({"flops": float(self.flops),
                 "bytes accessed": float(self.bytes)},
                dict(self.collectives))

    # ---- dispatch ----------------------------------------------------
    def __enter__(self):
        self._hooks = _hook_propagation()
        self._hooks.__enter__()
        try:
            return super().__enter__()
        except BaseException:
            self._hooks.__exit__(None, None, None)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            hooks, self._hooks = self._hooks, None
            hooks.__exit__(None, None, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, torch.Tensor) and t.__name__ == "DTensor"
               for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _PROPAGATING.depth:
            return out
        name = func.name() if hasattr(func, "name") else str(func)
        outs = _tensors(out)
        kind = _collective_kind(name)
        if kind is not None:
            # a c10d op that returns only its Work (``alltoall_base_``)
            # writes its first argument, the output buffer
            moved = outs or _tensors(args[:1])
            self.collectives[kind] += sum(_nbytes(t) for t in moved)
        elif not _is_view(func):
            n = (sum(_nbytes(t) for t in _tensors(args))
                 + sum(_nbytes(t) for t in _tensors(kwargs))
                 + sum(_nbytes(t) for t in outs))
            self.bytes += n
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            f = formula(*args, **kwargs, out_val=out)
            self.flops += f
            self.by_op[name] = self.by_op.get(name, 0) + f
        for t in outs:
            self._add_storage(t)
        return out
