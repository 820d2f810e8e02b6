"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>.so`` under the
repository root (a directory ``.gitignore`` lists): a plain C interface,
compiled for ``sm_90a`` at first use and rebuilt when its source is newer
than the library. Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of each library's C entry points
_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "fedavg_reduce": {
        # (x, w, out, n, m, dtype, stream) -> cudaError_t
        "fedavg_reduce_launch": (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
    },
    "delta_codec": {
        # (q, w, qr, wr, out, n, m, stream); qr = wr = None for one plane
        "int8_reduce_launch": (
            [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_void_p],
            ctypes.c_int),
        # (ref, q, s, qr, rs, out, m, dtype, stream)
        "int8_apply_launch": (
            [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_void_p],
            ctypes.c_int),
        # (vals, idx, w, out, n, s, m, stream)
        "topk_reduce_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p],
            ctypes.c_int),
        # (ref, vals, idx, acc, out, s, m, dtype, stream)
        "topk_apply_launch": (
            [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` report (registers, spills) of each library built here
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build_all(names: Optional[List[str]] = None) -> List[str]:
    """Compile every stale source, one ``nvcc`` per source, all started
    together; returns the names built, or raises with the output of each
    compile that failed."""
    names = [n for n in (list(_SIGNATURES) if names is None else names)
             if _stale(n)]
    if not names:
        return names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in names:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {n}.cu (exit {proc.returncode})"
                          f":\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
            build_logs[n] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` with its argtypes set, built if stale."""
    if name not in _loaded:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]
