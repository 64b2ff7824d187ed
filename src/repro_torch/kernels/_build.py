"""Build and load the Hopper kernels (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` -- no PyTorch
headers, so a build takes seconds.  Libraries go into ``_build/`` beside
this file (listed in ``.gitignore``), named by a hash of the source, the
headers beside it and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  All sources that need building are
compiled in parallel, one ``nvcc`` each.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found (no CUDA toolkit): the Hopper kernels are built "
            "from csrc/ on first use on a machine with the toolkit")
    exe = Path(CUDA_HOME) / "bin" / "nvcc"
    if not exe.exists():
        raise RuntimeError(f"nvcc not found under CUDA_HOME={CUDA_HOME}")
    return str(exe)


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Build every ``csrc/*.cu`` whose library is missing, all ``nvcc``
    processes started together; return ``{stem: dict(path, seconds,
    built)}``.  Raises ``RuntimeError`` with the compiler's output when a
    build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out, procs = {}, {}
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            so = _target(src)
            out[src.stem] = dict(path=str(so), seconds=0.0, built=False)
            if so.exists():
                continue
            tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, so)
        failures = []
        for stem, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)   # a concurrent loader sees all or nothing
            out[stem].update(seconds=time.perf_counter() - t0, built=True)
        if failures:
            raise RuntimeError("kernel build failed: " + "\n".join(failures))
        return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    lib = _loaded.get(stem)
    if lib is not None:
        return lib
    info = build_all()
    if stem not in info:
        raise RuntimeError(f"no kernel source csrc/{stem}.cu")
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            lib = ctypes.CDLL(info[stem]["path"])
            _loaded[stem] = lib
    return lib


def bind(stem: str, fn: str, n_ptrs: int, n_sizes: int, n_ints: int):
    """The C launcher ``fn`` of ``csrc/<stem>.cu`` with its argument types
    set: ``n_ptrs`` pointers, ``n_sizes`` 64-bit sizes, ``n_ints`` ints,
    then the stream; it returns the launch's CUDA error code."""
    f = getattr(library(stem), fn)
    if f.argtypes is None:
        f.argtypes = ([ctypes.c_void_p] * n_ptrs
                      + [ctypes.c_longlong] * n_sizes
                      + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        f.restype = ctypes.c_int
    return f


def launch(name: str, fn, *args) -> None:
    """Call a bound launcher and raise on a nonzero CUDA error code (a
    launch the driver refused never runs, and a later synchronise would
    not report it)."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check(name: str, t, dtypes, numel=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous 1-D CUDA tensor of one of
    ``dtypes`` (of ``numel`` elements and on ``device``, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got "
                         f"{t.device}; the plain version serves the CPU")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D tensor, got "
                         f"shape {tuple(t.shape)}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")
