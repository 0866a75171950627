"""The readings a cell's correctness limits are set from, on the card.

    python3 -m rainbench.calibrate --workload <cell> \\
        --seeds 1,2,... [--bf16-seeds 7,8,9] [--tf32-seeds 7,8,9]

In one process: for each seed of ``--seeds`` the program is set up as a
run sets it up and renders every pool batch once (the run's warm-up,
at the cell's own load), and its outputs are judged against the
reference on the run's sample; the same for the seeds of each control
(``harness.CONTROLS``: the program in a lower precision, which the
limits must fail). One JSON line a seed: the card, every number of
``check.numbers``, ``correct`` by the cell's limits where it has them,
the program's and the reference's ladders, and the seconds set-up and
the reference took. Exits 1 without a CUDA card.
"""

import argparse
import json
import sys
import time

import torch

from rainbench import card, check, harness, spec


def reading(cell, seed: int, control=None) -> dict:
    """One seed's reading on the card, the program in ``control``'s
    precision (None: as the configuration states)."""
    harness.kernels("cuda")
    t = time.perf_counter()
    pool, prog, kept = harness.setup(cell, seed, "cuda", control)
    ladder = prog.ladder()
    judged, truncated = prog.judged(), prog.truncated()
    del prog
    t_setup = time.perf_counter() - t
    verdict = check.judge(cell, judged, kept, seed, truncated)
    torch.cuda.synchronize()
    rec = {"card": torch.cuda.get_device_name(), "seed": seed,
           "control": control,
           "correct": verdict.correct if cell.limits["numbers"] else None,
           **verdict.numbers, "program_ladder": ladder, "setup_s": t_setup,
           "reference_s": time.perf_counter() - t - t_setup}
    del pool, judged, kept
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rainbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    for c in harness.CONTROLS:
        ap.add_argument(f"--{c}-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rainbench.calibrate: needs a CUDA card", file=sys.stderr)
        return 1
    cell = spec.cell(args.workload, held=spec.has_limits(args.workload))
    print(f"# card: {card.name_and_limit()}", file=sys.stderr)

    def seeds(s):
        return [int(v) for v in s.split(",") if v]

    groups = [(None, seeds(args.seeds))] + [
        (c, seeds(getattr(args, f"{c}_seeds"))) for c in harness.CONTROLS]
    for control, group in groups:
        for seed in group:
            print(json.dumps(reading(cell, seed, control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
