"""Build and bind the port's CUDA kernels.

At first use, ``load()`` compiles every ``src/repro_torch/csrc/*.cu`` with
``nvcc`` for ``sm_90a`` into one shared library with a plain C interface
under ``build/repro_torch/`` (named by a hash of the sources and flags, so
an edit rebuilds), and binds it with ``ctypes``.  Nothing is compiled at
import time; a machine without ``nvcc`` fails here, at the first launch.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, mask, part, out, G, C, N, cols, stream
    "rp_pass1": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, mask, w, out, G, C, N, cols, mode, trim_frac, stream
    "rp_combine": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # x, part, out, G, C, N, chunk, stream
    "rp_gram": [_P, _P, _P, _I, _I, _I, _I, _P],
}


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


def load():
    """The bound kernel library, compiled on first use."""
    if _Built.lib is not None:
        return _Built.lib
    sources = sorted(_SRC.glob("*.cu"))
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        digest.update(s.read_bytes())
    so = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        _Built.log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _Built.lib = lib
    return lib


def build_log():
    return _Built.log
