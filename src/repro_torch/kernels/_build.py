"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>.so`` under the
repository root (a directory ``.gitignore`` lists): a plain C interface,
compiled for ``sm_90a`` at first use and rebuilt when its source, or a
shared header ``csrc/*.cuh``, is newer than the library. Nothing here runs
at import time: the CPU tests import every module on a machine with no
``nvcc``. ``load`` is safe to call from several threads (packed fleet
points), and so is ``count_launch``, which every kernel wrapper's launch
counter goes through.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes signatures of each library's C entry points
_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "fedavg_reduce": {
        # (leaves, count, w, n, dtype, out_dtype, blocks, stream) ->
        # cudaError_t; leaves: the launch's table, packed on the host
        "fedavg_reduce_tree_launch": (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
        # (int out[4]) -> void: threads, max leaves, rows a chunk (two paths)
        "fedavg_reduce_layout": ([ctypes.c_void_p], None),
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
        # (ref, vals, idx, out, s, m, dtype, stream)
        "topk_apply_launch": (
            [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
    },
    "flash_attention": {
        # (q, k, v, o, dims[6], strides[12], causal, window, softcap, scale,
        #  stream), bf16; dims and strides are host int64 arrays
        "flash_attention_wgmma_launch": (
            [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_void_p],
            ctypes.c_int),
        # (q, k, v, o, qs, ks, vs, dims[6], strides[12], causal, window,
        #  softcap, scale, stream), f32; qs, ks, vs the bf16 plane scratch
        "flash_attention_split_launch": (
            [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_void_p],
            ctypes.c_int),
    },
    "moe_gmm": {
        # (x, w, out, E, C, d, f, dtype, vec, stream)
        "gmm_launch": (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            ctypes.c_int),
        # (x, w, out, E, C, d, f, stream), bf16 only
        "gmm_wgmma_launch": (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            ctypes.c_int),
        # the same, f32 only (each operand split into bf16 hi + lo)
        "gmm_wgmma_split_launch": (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
            ctypes.c_int),
    },
    "ssd_scan": {
        # (x, dt, A, b, c, D, y, final_state, cs, states, cb, sprev,
        #  dims[6], strides[6], dtype, path, stream); dims and strides are
        #  host int64 arrays
        "ssd_scan_launch": (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
            ctypes.c_int),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
#: the one lock of every kernel wrapper's launch counter
LAUNCH_LOCK = threading.Lock()
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
    """The library is missing, or older than its source or than any shared
    header (``csrc/*.cuh``, which every source may include)."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


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
        with _load_lock:
            if name not in _loaded:
                build_all([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                for fn, (argtypes, restype) in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                _loaded[name] = lib
    return _loaded[name]


def count_launch(counts: dict, key: str, n: int = 1) -> None:
    """``counts[key] += n`` under ``LAUNCH_LOCK``, so a counter stays exact
    when several threads launch kernels. A wrapper's module-level int
    counter passes its module's ``globals()``."""
    with LAUNCH_LOCK:
        counts[key] += n
