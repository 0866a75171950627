"""Build the package's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel, built by nvcc) or
``csrc/<name>.cc`` (host C++, the particle-XML parser, built by g++)
exposes a plain C interface and is compiled at first use (or all at
once by :func:`build_all`, one compiler per source in parallel) into
``raintpu_torch/_build/<name>-<hash>.so``, where the hash covers the
source and the compiler flags, so an edited source rebuilds and an
unchanged one loads the library already built. A variant of a source
built with preprocessor ``defines`` (e.g. ``("RAINTPU_ABLATE=3",)``,
passed as ``-D`` flags that the hash covers) is a library of its own;
with no defines the command line, the hash and the path are those of
the plain build. Nothing here includes PyTorch's headers: a build takes
seconds.
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
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_loaded = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def _source(name: str) -> Path:
    """csrc/<name>.cu, else csrc/<name>.cc."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _flags(src: Path, defines=()) -> tuple:
    base = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
    return base + tuple(f"-D{d}" for d in defines)


def _compiler(src: Path):
    if src.suffix == ".cu":
        return [nvcc_path()]
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")
    return [gxx]


def library_path(name: str, defines=()) -> Path:
    src = _source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        _flags(src, defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str, defines=()) -> Path:
    """Compile csrc/<name>.cu (or .cc) with ``defines`` unless that
    library is built."""
    return build_all([name], [defines])[0]


def build_all(names, defines=()) -> list:
    """Compile every library of ``names`` not built yet, one compiler
    process per library, all started together. ``defines``: one tuple
    of preprocessor defines per name (empty: none for any name), so one
    call can build several variants of a source. Returns the libraries'
    paths."""
    defines = list(defines) or [()] * len(names)
    if len(defines) != len(names):
        raise ValueError("build_all: one tuple of defines per name")
    outs = [library_path(name, d) for name, d in zip(names, defines)]
    jobs = []
    for name, d, out in zip(names, defines, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = _source(name)
        cmd = [*_compiler(src), *_flags(src, d), "-o", str(tmp), str(src)]
        jobs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for cmd, tmp, out, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"build failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(name: str, defines=()) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name> with ``defines``, once per
    (name, defines) per process."""
    key = (name, tuple(defines))
    if key not in _loaded:
        _loaded[key] = ctypes.CDLL(str(build(name, key[1])))
    return _loaded[key]
