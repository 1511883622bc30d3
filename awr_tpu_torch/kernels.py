"""Build and load the port's hand-written CUDA kernels and its host C++.

Each ``awr_tpu_torch/csrc/<name>.cu`` exposes a plain ``extern "C"``
launcher.  It is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/awr_tpu_torch/lib<name>-<hash>.so`` at first use and bound with
``ctypes``.  A ``csrc/<name>.cpp`` is host code (the PNG unfilter, the
Predictor's window packing): the host C++ compiler (``c++`` or ``g++`` on
PATH) builds it the same way.
The hash covers the source, for a ``.cu`` every header under ``csrc/``
(``*.cuh``), and the flags, so an edited source or header is rebuilt.
A missing compiler or a failed build raises.  Builds are serialized by
a module lock: the server's dispatcher thread may load a kernel while
another thread does.  Nothing here runs when the module is imported.

Every call of the built code goes through :func:`bind`, which declares a
symbol's argument and return types, and a device kernel's launch through
:func:`launch`, which passes the current stream, raises on a CUDA error
and counts the launch in :data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "awr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")
# one build at a time in this process: two threads that both find a
# library missing would otherwise run two compilers onto one temporary
# file (it is named by the process), and lru_cache does not serialize the
# first calls of ``load``
_LOCK = threading.Lock()

# The argument types of the launchers' signatures.
PTR, INT, I64, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)

# Launches of each hand-written kernel, by name, since the count was last
# cleared (``LAUNCHES.clear()``).
LAUNCHES = collections.Counter()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return nvcc


def host_compiler():
    """The host C++ compiler on PATH (``c++``, else ``g++``), or None."""
    return shutil.which("c++") or shutil.which("g++")


def _cxx() -> str:
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) on PATH: the "
                           "host C++ under csrc/ is built with one")
    return cxx


def _source(name: str) -> Path:
    for suffix in (".cu", ".cpp"):
        if (CSRC / f"{name}{suffix}").exists():
            return CSRC / f"{name}{suffix}"
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def library_path(name: str) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    src = _source(name)
    if src.suffix == ".cu":
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [_cxx(), *HOST_FLAGS, "-o", str(out), str(src)]


def build(names) -> dict:
    """Compile the named sources that are not built yet, all at once (one
    compiler process each).  Returns ``{name: {"seconds", "ptxas"}}``
    for what was compiled (``ptxas``: the compiler's output); raises if
    any compile fails."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            proc = subprocess.Popen(_command(name, tmp),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, out, time.perf_counter())
        report, failed = {}, []
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            # atomic: a concurrent build never loads half a file
            os.replace(tmp, out)
            report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if failed:
            raise RuntimeError("build failed for " + "\n".join(failed))
        return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` or ``.cpp``, built first
    if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.lru_cache(maxsize=None)
def bind(name: str, symbol: str, argtypes: tuple, restype=INT):
    """The function ``symbol`` of the built library ``name`` (:func:`load`)
    with its argument types ``argtypes`` and return type ``restype``
    declared."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` where its base is 16-byte aligned (as a kernel's vector loads
    and TMA read it), else a copy (a fresh allocation is)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(kernel: str, fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` on ``device`` and its current stream: ``fn``
    a launcher from :func:`bind` whose last argument is the stream and
    which returns a CUDA error code.  A nonzero code raises
    ``RuntimeError`` naming ``kernel``; a launch is counted in
    ``LAUNCHES[kernel]``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
