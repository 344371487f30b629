"""The op log of one call: the port's twin of ``repro/analysis/traversal.py``.

The reference walks a jaxpr, descending into every sub-jaxpr (scan and
cond bodies, ``pallas_call`` kernels), and pins each eqn to its source
line.  The port has no graph to walk.  An entry runs once under
``OpLog``, a ``TorchDispatchMode`` built on ``launch/roofline.CostCounter``
(the same byte, flop and collective counts, the same hooks that leave
DTensor's own bookkeeping out), which records every aten op the call runs:

  * its name (the overload packet: ``cat``, ``copy_``, ``mm``, ...);
  * the shape, dtype, device, strides and storage of each tensor it reads
    and writes (``TensorInfo``);
  * its provenance, ``file:line (fn)`` of the innermost frame under
    ``src/repro_torch/`` (of the caller's own frame where none is, as for
    a test's program), as the reference pins an eqn to its user frame;
  * for a random op its generator and that generator's state before the
    draw; for a matmul or a convolution whether TF32 was on.

**Kernel regions.**  The CUDA kernels are bound through ``ctypes``
(``kernels/_build.py``), so on the card a dispatch mode sees none of them,
while on the CPU it sees every aten op of their plain versions.  So that a
rule gives one verdict on both devices, the call of each function where a
kernel launches or its plain version runs (``kernel_sites``: the wrappers
of ``kernels/launches.py`` and the dispatchers of the fused pipeline they
share) is one opaque region, as a ``pallas_call`` sub-jaxpr is to the
reference's rules.  The region is marked by ``sys.monitoring`` events on
those functions' code objects alone: no op inside it is logged, and its
arguments and result count once, as one op's bytes.  ``OpLog.regions``
holds each region's launch counter name, arguments and dynamic shared
memory at those shapes.

``repro/analysis/hlo.py`` has no twin module.  Its collective-bytes
parser is ``CostCounter.collectives`` (the reference's kind names, bytes
on this rank), and its ``input_output_alias`` map becomes a comparison of
the carried buffers' storages before and after the call
(``storage_of``).
"""
from __future__ import annotations

import dataclasses
import math
import sys
import sysconfig
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.launch import roofline

_PKG = str(Path(__file__).resolve().parents[1])          # src/repro_torch
_OWN = (str(Path(__file__).resolve().parent),
        str(Path(roofline.__file__).resolve()))
_LIBS = (str(Path(torch.__file__).resolve().parent),
         sysconfig.get_paths()["stdlib"])

HALF = (torch.bfloat16, torch.float16)
MATMULS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "dot", "mv",
           "addmv", "linear", "_scaled_dot_product_flash_attention",
           "_scaled_dot_product_efficient_attention"}
CONVS = {"convolution", "_convolution", "cudnn_convolution",
         "convolution_backward"}


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    """What a rule reads of one tensor an op touched."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    stride: Tuple[int, ...]
    storage: int                    # the storage's data pointer (0: none)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.numel * self.dtype.itemsize

    @property
    def permuted(self) -> bool:
        """Whether the layout is a permutation of a row-major one (a
        transpose or ``permute`` view): its strides, over the dims of more
        than one element, are not in decreasing order."""
        st = [s for n, s in zip(self.shape, self.stride) if n > 1 and s]
        return any(a < b for a, b in zip(st, st[1:]))

    def __str__(self) -> str:
        dt = str(self.dtype).replace("torch.", "")
        return f"{dt}[{','.join(map(str, self.shape))}]"


def tensor_info(t: torch.Tensor) -> TensorInfo:
    return TensorInfo(tuple(t.shape), t.dtype, str(t.device),
                      tuple(t.stride()), storage_of(t))


def storage_of(t: torch.Tensor) -> int:
    """The data pointer of ``t``'s storage: two tensors with the same one
    share their memory."""
    return t.untyped_storage().data_ptr()


@dataclasses.dataclass
class Op:
    """One aten op of the call."""
    name: str                       # overload packet: "cat", "copy_", ...
    ins: List[TensorInfo]
    outs: List[TensorInfo]
    provenance: str
    dim: Optional[int] = None       # cat / stack: the axis (non-negative)
    random: bool = False            # a seeded random op
    explicit: bool = False          # ... given an explicit generator
    gen_state: Optional[bytes] = None   # that generator's state before it
    tf32: bool = False              # a matmul / conv run with TF32 on

    @property
    def out(self) -> Optional[TensorInfo]:
        return self.outs[0] if self.outs else None


@dataclasses.dataclass
class Region:
    """One call of a kernel site: the kernel on the card, its plain
    version on the CPU."""
    launch: str                     # its launch counter's name
    args: Dict[str, TensorInfo]     # its tensor arguments
    scalars: Dict[str, object]      # and the others that are numbers
    smem: Optional[int]             # dynamic shared memory at these shapes
                                    # (None: the kernel's is all static)
    smem_note: str = ""


@dataclasses.dataclass(frozen=True)
class Site:
    fn: object                      # the function
    counter: object                 # f(args) -> (counter wrapper, mode)
    smem: object                    # f(args) -> (bytes or None, note)


def launch_name(wrapper, mode) -> str:
    """The kernels line's name of a launch counter (``chip_smoke.py``):
    ``gated_combine[trimmed]``, ``paged_flash_decode[int8]``, ..."""
    from repro_torch.kernels import paged_decode as pd
    if wrapper is pd.paged_flash_decode:
        return wrapper.__name__ + ("[int8]" if mode == "int8" else "")
    return wrapper.__name__ + (f"[{mode}]" if mode is not None else "")


def kernel_sites() -> Dict[object, Site]:
    """{code object: Site} of every function where a kernel launches on the
    card and its plain version runs on the CPU.  K1-K3 and K4a-c launch
    from ``robust_pipeline``'s ``_pass1`` / ``_combine`` / ``_gram``, which
    every wrapper and the fused pipelines share (the counter is their
    ``wrapper`` argument); K7's fused launch from ``topd_pallas``, counted
    on ``block_topd``."""
    from repro_torch.comm.kernels import comm_codecs as cc
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import population_select as ps
    from repro_torch.kernels import robust_agg as ra
    from repro_torch.kernels import robust_pipeline as rp

    def cn(x):                          # one matrix or leaves side by side
        return rp.dims(x)[-2:]

    def pass1(x):
        return rp.pass1_smem_bytes(*cn(x)), "pass1_smem_bytes"

    def combine(x, mode):
        return rp.combine_smem_bytes(*cn(x), mode), "combine_smem_bytes"

    def static(a):
        return None, "static shared memory only"

    def topd(a, merge):
        blk = max(int(a["blk"]), int(a["d"])) if merge else int(a["blk"])
        n = ps.smem_bytes(blk, int(a["d"]))
        if merge and n > rp.SMEM_LIMIT and blk == int(a["d"]):
            return None, (f"smem_bytes {n} B past the limit: the global "
                          "path (ps_topd_global), no shared-memory block")
        return n, "population_select.smem_bytes"

    def paged(a):
        q, kp = a["q"], a["kp"]
        return (pd.smem_bytes(q.shape[1] // kp.shape[2], q.shape[2]),
                "paged_decode.smem_bytes")

    def flash(a):
        q = a["q"]
        return (fa.smem_bytes(q.shape[-1], q.dtype),
                "flash_attention.smem_bytes")

    sites = [
        Site(rp._pass1, lambda a: (a["wrapper"], None),
             lambda a: pass1(a["x"])),
        Site(rp._combine, lambda a: (a["wrapper"], a["mode"]),
             lambda a: combine(a["x"], a["mode"])),
        Site(rp._gram, lambda a: (a["wrapper"], None), static),
        Site(cc.dequant_gate_partials,
             lambda a: (cc.dequant_gate_partials, None),
             lambda a: pass1(a["q"])),
        Site(cc.dequant_gated_combine,
             lambda a: (cc.dequant_gated_combine, a["mode"]),
             lambda a: combine(a["q"], a["mode"])),
        Site(cc.dequant_pairwise_gram,
             lambda a: (cc.dequant_pairwise_gram, None), static),
        Site(ra.robust_agg_fwd, lambda a: (ra.robust_agg_fwd, a["mode"]),
             lambda a: combine(a["x"], a["mode"])),
        Site(ps.block_topd, lambda a: (ps.block_topd, None),
             lambda a: topd(a, False)),
        Site(ps.topd_pallas, lambda a: (ps.block_topd, None),
             lambda a: topd(a, True)),
        Site(pd.paged_flash_decode,
             lambda a: (pd.paged_flash_decode,
                        "int8" if a["k_scale"] is not None else "fp32"),
             paged),
        Site(fa.flash_attention_fwd, lambda a: (fa.flash_attention_fwd,
                                                None), flash),
    ]
    return {s.fn.__code__: s for s in sites}


def provenance(frame) -> str:
    """``file:line (fn)`` of the innermost frame under ``src/repro_torch/``
    outside this package; else of the innermost frame outside torch, the
    standard library and this package (a test's own program); '?' when
    there is none."""
    fallback = None
    while frame is not None:
        path = frame.f_code.co_filename
        if not path.startswith(_OWN) and not path.startswith(_LIBS):
            if path.startswith(_PKG):
                return _where(frame, path[len(_PKG) - len("repro_torch"):])
            if fallback is None:
                fallback = _where(frame, path.rsplit("/", 1)[-1])
        frame = frame.f_back
    return fallback or "?"


def _where(frame, path):
    return f"{path}:{frame.f_lineno} ({frame.f_code.co_name})"


_TOOL_NAME = "repro_torch.analysis"


class OpLog(roofline.CostCounter):
    """``CostCounter`` that also logs the ops of the call (``ops``) and its
    kernel regions (``regions``).  Use as a context around one call."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self.regions: List[Region] = []
        self._sites = kernel_sites()
        self._open = []             # code objects of the regions entered
        self._tool = None

    # ---- kernel regions ----------------------------------------------
    def _start(self, code, offset):
        if not self._open:
            site = self._sites[code]
            args = dict(sys._getframe(1).f_locals)
            counter, mode = site.counter(args)
            smem, note = site.smem(args)
            self.regions.append(Region(
                launch_name(counter, mode),
                {k: tensor_info(v) for k, v in args.items()
                 if isinstance(v, torch.Tensor)},
                {k: v for k, v in args.items()
                 if isinstance(v, (bool, int, float, str))}, smem, note))
            self.bytes += sum(roofline._nbytes(v) for v in args.values()
                              if isinstance(v, torch.Tensor))
        self._open.append(code)

    def _return(self, code, offset, value):
        self._open.pop()
        if not self._open:
            self.bytes += sum(roofline._nbytes(t)
                              for t in roofline._tensors(value))

    def _monitor(self, on):
        mon = sys.monitoring
        if on:
            self._tool = next(i for i in (3, 4, 1, 0)
                              if mon.get_tool(i) is None)
            mon.use_tool_id(self._tool, _TOOL_NAME)
            mon.register_callback(self._tool, mon.events.PY_START,
                                  self._start)
            mon.register_callback(self._tool, mon.events.PY_RETURN,
                                  self._return)
            events = mon.events.PY_START | mon.events.PY_RETURN
        else:
            events = mon.events.NO_EVENTS
        for code in self._sites:
            mon.set_local_events(self._tool, code, events)
        if not on:
            mon.register_callback(self._tool, mon.events.PY_START, None)
            mon.register_callback(self._tool, mon.events.PY_RETURN, None)
            mon.free_tool_id(self._tool)
            self._tool = None

    def __enter__(self):
        self._monitor(True)
        try:
            return super().__enter__()
        except BaseException:
            self._monitor(False)
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._monitor(False)
            self._open.clear()

    # ---- ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, torch.Tensor) and t.__name__ == "DTensor"
               for t in types):
            return NotImplemented
        if self._open:                          # inside a kernel region
            return func(*args, **kwargs)
        random = torch.Tag.nondeterministic_seeded in func.tags
        state = None
        if random:
            # the op receives a new Python object for the generator, so a
            # draw is known by the state it starts from, not by identity
            gen = kwargs.get("generator")
            if gen is None:
                gen = next((a for a in args
                            if isinstance(a, torch.Generator)), None)
            state = None if gen is None else gen_state(gen)
        name = func._overloadpacket.__name__
        tf32 = ((name in MATMULS and torch.backends.cuda.matmul.allow_tf32)
                or (name in CONVS and torch.backends.cudnn.allow_tf32))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if roofline._PROPAGATING.depth:
            return out
        dim = None
        if name in ("cat", "stack"):
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
        outs = [tensor_info(t) for t in roofline._tensors(out)]
        if dim is not None and dim < 0 and outs:
            dim += len(outs[0].shape)
        self.ops.append(Op(
            name,
            [tensor_info(t) for t in roofline._tensors(args)
             + roofline._tensors(kwargs)],
            outs, provenance(sys._getframe(1)), dim, random,
            state is not None, state, tf32))
        return out

    # ---- queries -----------------------------------------------------
    def launches(self) -> Dict[str, int]:
        """{launch counter name: regions}: on the CPU, the kernels the
        call would launch on the card."""
        out: Dict[str, int] = {}
        for r in self.regions:
            out[r.launch] = out.get(r.launch, 0) + 1
        return out


def generators(trees) -> List[torch.Generator]:
    """The distinct ``torch.Generator`` leaves of ``trees``."""
    out = []
    for t in trees:
        for leaf in tree.leaves(t):
            if isinstance(leaf, torch.Generator) and all(
                    leaf is not g for g in out):
                out.append(leaf)
    return out


def gen_state(g: torch.Generator) -> bytes:
    """A generator's state with its device: two draws that start from the
    same one repeat their bits."""
    return str(g.device).encode() + g.get_state().numpy().tobytes()
