"""Run one cell of the benchmark of raintpu_torch.

    python3 -m rainbench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames rendered in the window), ``failed`` (frames
judged wrong), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown`` and ``trace`` (what the profiles cost), ``build`` (the
kernels compiled in this run, empty but on a checkout's first, and the
seconds build and load took, part of ``setup_s``), ``card`` (its name,
power limit, and SM clock and power draw over the window), and last
``checks``: each number compared with the reference beside its limit,
which also end standard error. A traced run writes its profile with
host operations to ``rainbench_out/<cell>-<seed>.json.gz``.

Exits 1 and prints no result without the cards the cell asks for, and
2 if ``jax``, ``jaxlib``, ``flax`` or ``raintpu`` (whole top-level
module names) was imported once the window closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raintpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".rainbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m rainbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from rainbench import spec

    cache_dirs(str(spec.ROOT))
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rainbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    from rainbench import harness

    result, checks = harness.run(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", T0,
        trace_name=f"{args.workload}-{args.seed}" if args.trace else None)
    bad = forbidden_modules()
    if bad:
        print(f"rainbench: the run imported {', '.join(bad)}",
              file=sys.stderr)
        return 2
    print(f"# card: {result['card']}", file=sys.stderr)
    print(f"# build: {result['build']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
