"""Build, load and count the port's CUDA kernels.

Each kernel is one source ``csrc/<name>.cu`` with a plain C entry point
(shared device code lives in headers ``csrc/*.cuh``).
On its first use it is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``fieldconv_tpu_torch/_build/`` and loaded with ``ctypes``;
a failed build raises.

``launches`` counts kernel launches by name.  A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches: collections.Counter = collections.Counter()
# nvcc output (ptxas register and spill lines) of each source compiled by
# this process
build_logs: dict = {}

_libs: dict = {}


def reset_launches() -> None:
    launches.clear()


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any shared
    header (csrc/*.cuh)."""
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [f"{name}.cu"] + [f for f in os.listdir(CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(
        os.path.getmtime(os.path.join(CSRC, f)) for f in deps)


def _start_build(name: str):
    """Start nvcc on csrc/<name>.cu; returns (process, temporary output)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = _lib_path(name) + f".tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish_build(name: str, proc, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _lib_path(name))
    build_logs[name] = out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    if name not in _libs:
        if _stale(name):
            _finish_build(name, *_start_build(name))
        _libs[name] = ctypes.CDLL(_lib_path(name))
    return _libs[name]


def build_all() -> None:
    """Build every stale kernel source, one nvcc per source all started
    together, then load every library."""
    names = sources()
    started = {n: _start_build(n) for n in names if _stale(n)}
    try:
        for n, (proc, tmp) in started.items():
            _finish_build(n, proc, tmp)
    finally:
        for proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for n in names:
        library(n)
