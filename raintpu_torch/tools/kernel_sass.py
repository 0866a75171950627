"""What nvcc made of the raster kernel and its knockout variants, on a
machine with the CUDA toolkit.

For each variant of ``kernel_ablation.LADDER`` (built as the ablation
builds them) it prints each kernel instantiation's instruction count and
the counts of the opcodes the knockouts touch (``cuobjdump -sass``), and
the registers and spill stores ``ptxas -v`` reports: a knockout that
prices more than it names would show here as arithmetic gone with the
store it fed. ``--against SRC`` also compiles another version of
``csrc/fused_raster.cu`` (e.g. a parent commit's) with the production
flags and prints whether the production library's SASS equals it, the
kernels' mangled names aside (nvcc hashes the source's path into the
unnamed namespace's name), instantiation by instantiation for those the
other source has (a source from before the bfloat16 planes has only the
float32 ones).

Usage:  python -m raintpu_torch.tools.kernel_sass [--against SRC]
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import tempfile

from raintpu_torch import cuda_build
from raintpu_torch.ops.fused_raster import ablate_defines
from raintpu_torch.tools import kernel_ablation

# An instruction line: /*address*/ [predicate] OPCODE.modifiers ...
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)")
FUNCTION = re.compile(r"^\s*Function : (\S+)", re.M)
# A kernel instantiation's template arguments in its mangled name: the
# rank ceiling, and the planes' type (absent before bfloat16 planes).
INSTANTIATION = re.compile(r"ILi(\d+)E(?:(f|13__nv_bfloat16)E)?")
OPCODES = ("MUFU", "FADD", "FMUL", "FFMA", "LDS", "STS", "LDG", "STG", "BAR",
           "SHFL", "BRA")


def sass(library) -> str:
    """``cuobjdump -sass`` of a built library."""
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    return subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def opcode_mix(text: str) -> dict:
    """{kernel instantiation: Counter of opcodes} of a SASS listing."""
    names = FUNCTION.findall(text)
    bodies = FUNCTION.split(text)[2::2]
    return {name: collections.Counter(INSTR.findall(body))
            for name, body in zip(names, bodies)}


def instantiation(name: str) -> str:
    """A kernel's label from its mangled name: "<rank, planes' type>"."""
    m = INSTANTIATION.search(name)
    if not m:
        return name
    store = "bf16" if m.group(2) == "13__nv_bfloat16" else "float"
    return f"<{m.group(1)}, {store}>"


def bodies(text: str) -> dict:
    """{instantiation label: its SASS, names aside} of a listing."""
    return {instantiation(name): body for name, body in
            zip(FUNCTION.findall(text), FUNCTION.split(text)[2::2])}


def ptxas_usage(defines=()) -> list:
    """(registers, spill store bytes) of each kernel, as ptxas -v
    reports them for a build of csrc/fused_raster.cu with ``defines``."""
    src = cuda_build.CSRC / "fused_raster.cu"
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
             *(f"-D{d}" for d in defines), "-Xptxas", "-v",
             "-o", os.path.join(tmp, "lib.so"), str(src)],
            capture_output=True, text=True, check=True, timeout=600)
    log = out.stdout + out.stderr
    return list(zip(map(int, re.findall(r"Used (\d+) registers", log)),
                    map(int, re.findall(r"(\d+) bytes spill stores", log))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None,
                    help="another fused_raster.cu to compare the "
                         "production SASS with")
    args = ap.parse_args(argv)
    paths = kernel_ablation.build_variants()
    out = {}
    for (_, ablate, _, _), path in zip(kernel_ablation.LADDER, paths):
        text = sass(path)
        name = ablate or "production"
        for fn, ops in opcode_mix(text).items():
            print(f"sass {name:<40s} {instantiation(fn)} instructions "
                  f"{sum(ops.values())} " + " ".join(
                      f"{k}={ops.get(k, 0)}" for k in OPCODES), flush=True)
        usage = ptxas_usage(ablate_defines(ablate))
        print(f"ptxas {name:<40s} (registers, spill store bytes) {usage}",
              flush=True)
        out[name] = dict(library=path.name, mix=opcode_mix(text),
                         ptxas=usage)
    if args.against:
        with tempfile.TemporaryDirectory() as tmp:
            other = os.path.join(tmp, "against.so")
            subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                            "-o", other, args.against], check=True,
                           timeout=600)
            theirs = sass(other)
        mine, theirs = bodies(sass(paths[0])), bodies(theirs)
        same = {k: mine.get(k) == v for k, v in theirs.items()}
        print(f"production SASS by instantiation equals {args.against}'s, "
              f"the mangled names aside: {same} (here: {sorted(mine)})",
              flush=True)
        out["same_as_against"] = all(same.values())
    return out


if __name__ == "__main__":
    main()
