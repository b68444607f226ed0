"""Build and load the hand-written CUDA kernels (``trino_tpu_torch/csrc``).

Each ``csrc/*.cu`` source has a plain C interface and compiles with
``nvcc`` for ``sm_90a`` into its own shared library under
``build/torch_kernels/`` at the repository root; the libraries are
loaded with ``ctypes``. The sources compile in parallel (one ``nvcc``
per source, all started together) the first time any kernel is needed,
or when ``build_all()`` is called. A library newer than its source is
reused. Nothing here runs at import time: this module imports on a
machine without ``nvcc`` or a GPU, where only the kernels' plain torch
versions run.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "library", "call"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")

#: kernel name -> source file in csrc/
SOURCES = {
    "group_ids": "group_ids.cu",
    "seg_sum": "seg_sum.cu",
    "join_probe": "join_probe.cu",
    "expand_matches": "expand_matches.cu",
    "range_any": "range_any.cu",
    "scatter_any": "scatter_any.cu",
    "hash_keys": "hash_keys.cu",
    "pack_words": "pack_words.cu",
    "seg_minmax": "seg_minmax.cu",
    "order_words": "order_words.cu",
    "window_peers": "window_peers.cu",
    "range_sum": "range_sum.cu",
    "range_minmax": "range_minmax.cu",
    "seg_searchsorted": "seg_searchsorted.cu",
    "hll": "hll.cu",
    "seg_arg_extreme": "seg_arg_extreme.cu",
    "hll_merge": "hll_merge.cu",
    "quant_summary": "quant_summary.cu",
    "quant_merge": "quant_merge.cu",
    "partition_pack": "partition_pack.cu",
    "segment_reduce": "segment_reduce.cu",
}

NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels need the CUDA toolkit "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    headers = [f for f in os.listdir(CSRC) if f.endswith(".cuh")]
    newest = max(
        os.path.getmtime(os.path.join(CSRC, f))
        for f in (SOURCES[name], *headers)
    )
    return os.path.getmtime(lib) < newest


def build_all() -> dict:
    """Compile every stale kernel source, all in parallel.

    Returns ``{"seconds": wall, "built": [names]}``; raises RuntimeError
    with the compiler's output if any build fails."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = [n for n in SOURCES if _stale(n)]
        t0 = time.perf_counter()
        procs = {}
        nvcc = _nvcc() if todo else None
        for name in todo:
            tmp = _lib_path(name) + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, SOURCES[name])]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return {"seconds": time.perf_counter() - t0, "built": todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one kernel (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if any(_stale(n) for n in SOURCES):
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
    return lib


def launch_args(*args):
    """ctypes arguments for a launch: tensors pass their device pointer,
    ints pass as 64-bit, None as a null pointer."""
    out = []
    for a in args:
        if a is None:
            out.append(ctypes.c_void_p(None))
        elif isinstance(a, int):
            out.append(ctypes.c_longlong(a))
        else:
            out.append(ctypes.c_void_p(a.data_ptr()))
    return out


def call(name: str, fn: str, *args, stream=None) -> None:
    """Launch ``fn`` of kernel library ``name`` on ``stream`` (torch's
    current stream when None) and raise if the launch failed."""
    import torch

    lib = library(name)
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    rc = f(*launch_args(*args), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}.{fn}: CUDA error {rc} at launch")
