"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own
shared library with a plain C interface, at first use, into
`build/repro_torch_kernels/<hash>/` at the root of the checkout (the
directory `.gitignore` lists).  The hash covers every source and header
in `csrc/` and the nvcc flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  All sources compile in parallel, one
nvcc process each.

Nothing here runs at import time: the CPU tests import every module of
the package on a host with no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}                 # kernel name -> loaded ctypes.CDLL
BUILD_LOG: dict = {}             # kernel name -> {"seconds", "ptxas"}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" \
        / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "CUDA kernels are built on the GPU host")
    return found


def build_all() -> dict:
    """Compile every csrc/*.cu that is not built yet, all at once.
    Returns {name: library path}."""
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in sources()}
    todo = {n: p for n, p in libs.items() if not p.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, lib)             # atomic: readers never see half
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name` (built on first use)."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
