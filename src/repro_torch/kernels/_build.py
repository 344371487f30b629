"""Build and bind the port's CUDA kernels.

At first use, ``load()`` compiles every ``src/repro_torch/csrc/*.cu`` with
``nvcc`` for ``sm_90a`` (one ``nvcc`` a source, all started together), links
them into one shared library with a plain C interface under
``build/repro_torch/``, and binds it with ``ctypes``.  The library is named
by a hash of every file under ``csrc/`` (sources and headers) and of the
flags, so an edit to any of them rebuilds.  Nothing is compiled at import
time; a machine without ``nvcc`` fails here, at the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, mask, part, out, G, C, N, nblk, stream
    "rp_pass1": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, mask, w, out, G, C, N, cols, mode, trim_frac, stream
    "rp_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, part, out, G, C, N, chunk, stream
    "rp_gram": [_P, _P, _P, _I, _I, _I, _I, _P],
    # the same over L leaves side by side: seg (L pointers) and off (L + 1
    # ints), host arrays, then L and the dense entry point's arguments
    "rp_pass1_seg": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "rp_combine_seg": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "rp_gram_seg": [_P, _P, _I, _P, _P, _I, _I, _I, _I, _P],
    # q, s, table, mask, part, out, G, C, N, NQ, L, qblk, nblk, stream
    "cc_pass1": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, s, table, mask, w, out, G, C, N, NQ, L, qblk, cols, mode, trim_frac,
    # stream
    "cc_combine": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                   _P],
    # q, s, table, mask, part, out, G, C, N, NQ, L, qblk, chunk, stream
    "cc_gram": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # g, M, blk, d, vals, idx, out, counter, stream
    "ps_topd": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    # blk, d -> K7's shared memory a CTA, bytes
    "ps_topd_smem": [_I, _I],
    # g, M, blk, d, scratch, out, stream (K7 past its shared memory)
    "ps_topd_global": [_P, _I, _I, _I, _P, _P, _P],
    # M, blk, d -> the global path's scratch, bytes (long long)
    "ps_topd_global_bytes": [_I, _I, _I],
    # x, mask, out, C, N, cols, mode, trim_frac, stream
    "ra_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    # q, kp, vp, ks, vs, table, lengths, out, part, counter, q_bf16, int8,
    # S, hq, hkv, dh, page, maxp, splits, chunk, ctas, scale, stream
    "pd_decode": [_P] * 10 + [_I] * 11 + [_F, _P],
    # q, k, v, o, strides, dtype, B, Hq, Hkv, S, dh, causal, window, scale,
    # stream
    "fa_fwd": [_P] * 5 + [_I] * 8 + [_F, _P],
}
_RESTYPES = {"ps_topd_global_bytes": ctypes.c_longlong}


class _Built:
    lib = None
    log = ""            # nvcc's output (ptxas register / smem report)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _run(procs):
    """Waits for every nvcc process; raises with the output of a failed one."""
    log = ""
    for proc in procs:
        out, err = proc.communicate()
        log += out + err
        if proc.returncode != 0:
            for other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed:\n{out}\n{err}")
    return log


def _compile(so):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    sources = sorted(_SRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    popen = lambda args: subprocess.Popen(
        [_nvcc(), *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    log = _run([popen([*NVCC_FLAGS, "-c", "-o", str(o), str(s)])
                for s, o in zip(sources, objs)])
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log += _run([popen(["-shared", "-o", str(tmp), *map(str, objs)])])
    for o in objs:
        o.unlink()
    os.replace(tmp, so)
    _Built.log = log


def load():
    """The bound kernel library, compiled on first use."""
    if _Built.lib is not None:
        return _Built.lib
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in _SRC.rglob("*") if p.is_file()):
        digest.update(f.relative_to(_SRC).as_posix().encode())
        digest.update(f.read_bytes())
    so = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    _Built.lib = lib
    return lib


def build_log():
    return _Built.log
