"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at
first use (or all at once by :func:`build_all`, one nvcc per source in
parallel) into ``raintpu_torch/_build/<name>-<hash>.so``, where the hash
covers the source and the compiler flags, so an edited source rebuilds
and an unchanged one loads the library already built. Nothing here
includes PyTorch's headers: a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper with its architecture-specific features. --fmad=false
# keeps every multiply and add rounded on its own, as the plain PyTorch
# versions round them, so a kernel and its plain version agree to the
# order of their float sums (see ops.fused_raster).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_loaded = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built."""
    return build_all([name])[0]


def build_all(names) -> list:
    """Compile every csrc/<name>.cu not built yet, one nvcc process per
    source, all started together. Returns the libraries' paths."""
    outs = [library_path(name) for name in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
