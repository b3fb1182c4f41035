"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source ``repro_torch/csrc/<name>.cu`` with a
plain C interface. It is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``build/kernels/`` at the repo root (a directory
``.gitignore`` lists) and loaded with ``ctypes``. The library file name
carries a hash of the sources and flags, so an edited source is rebuilt and
a stale library is never loaded. Nothing is built when a module is
imported: :func:`load` builds at first use, and :func:`build` starts one
``nvcc`` per source, all at once.

A build that fails raises with the compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["KERNELS", "CSRC", "BUILD_DIR", "build", "load", "function",
           "check", "require", "stream_ptr", "dtype_code", "build_log"]

KERNELS = ("qmatvec", "qmatmul", "attn_decode", "attn_prefill",
           "attn_prefill_tc", "sigmoid_pw")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                      "-Xptxas", "-v", "-lineinfo"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}
build_log: Dict[str, str] = {}          # kernel -> ptxas/nvcc output


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    process per source, all started together. Returns {name: seconds}
    (0.0 where the library was already there). Raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    secs: Dict[str, float] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        # the compiler's output goes to a file, not a pipe: a pipe that
        # fills would stall nvcc until it is read
        logf = open(out.with_suffix(f".log{os.getpid()}"), "w+")
        procs[name] = (subprocess.Popen(cmd, stdout=logf,
                                        stderr=subprocess.STDOUT, text=True),
                       logf, tmp, out, time.perf_counter())
    errors = []
    while procs:
        for name, (p, logf, tmp, out, t0) in list(procs.items()):
            if p.poll() is None:
                continue
            secs[name] = time.perf_counter() - t0
            del procs[name]
            logf.seek(0)
            build_log[name] = logf.read()
            logf.close()
            os.remove(logf.name)
            if p.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu (rc {p.returncode}):"
                              f"\n{build_log[name]}")
                continue
            os.replace(tmp, out)
        time.sleep(0.05)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def function(name: str, argtypes, entry: str | None = None):
    """The C launch function ``<entry>_launch`` (``entry`` defaults to
    ``name``) of kernel library ``name`` with its argument types set
    (pointers and the stream as ``c_void_p``), loaded once."""
    entry = entry or name
    fn = _FNS.get(entry)
    if fn is None:
        fn = getattr(load(name), f"{entry}_launch")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        _FNS[entry] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def require(t: torch.Tensor, shape, dtypes, device, what: str) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` and one of
    ``dtypes`` on ``device`` — what every kernel's C interface assumes."""
    if (t.device != device or t.dtype not in dtypes
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{what}: need a contiguous {tuple(shape)} tensor "
                         f"of {dtypes} on {device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device} strides {t.stride()}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    """The C interface's element-type code: 0 fp32, 1 bf16, 2 int8."""
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
    if dtype not in codes:
        raise TypeError(f"unsupported dtype for the CUDA kernels: {dtype}")
    return codes[dtype]
