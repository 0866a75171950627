#!/usr/bin/env python
"""Multi-process render farm of the PyTorch port.

    python -m raintpu_torch.main_threaded --dataset customdb \\
        --intensity 25,50 --frames_per_thread 8 --frame_end 16 \\
        --max_threads 2 [--online] [--device cpu] [any other CLI flag]

Counterpart of the root ``main_threaded.py``: the same (intensity x
frame window x scene block) shards, tags, per-shard logs
(``automate_log_<tag>.txt``, ``automate_error_<tag>.txt`` in
``--log_dir``) and exit codes (1 when a shard failed, else 0). Each
shard is a child ``python -m raintpu_torch.cli`` run with
``--conflict_strategy skip --noverbose``, so a rerun resumes where the
outputs stop. Flags the farm does not know (``--device``, ``--online``,
``--batch_size``, ...) go to every child unchanged; children render on
the CUDA card unless ``--device cpu`` is passed, and several may share
one card (``--max_threads``).

Offline children (no ``--online``) of one intensity may each find that
intensity's particle XML missing and simulate it at the same time; run
``--online``, or simulate the files first
(``raintpu_torch.tools.particles_simulation``).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

# The directory holding the raintpu_torch package, put on the children's
# PYTHONPATH so ``-m raintpu_torch.cli`` resolves from any directory.
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = [sys.executable, "-m", "raintpu_torch.cli"]


def build_shards(args, passthrough):
    """(intensity x frame-window x scene-block) shard enumeration, as
    the root farm's. Frame windows require ``--frame_end`` so the range
    is known without touching the dataset."""
    seqs = args.sequences.split(",") if args.sequences else [""]
    fpt = getattr(args, "frames_per_thread", 0) or 0
    f0 = getattr(args, "frame_start", 0) or 0
    f1 = getattr(args, "frame_end", None)
    if fpt > 0:
        if f1 is None:
            raise SystemExit(
                "--frames_per_thread requires --frame_end (the farm "
                "can't discover sequence lengths without rendering)")
        windows = [(w, min(w + fpt, f1)) for w in range(f0, f1, fpt)]
    else:
        windows = [None]

    shards = []
    for intensity in args.intensity.split(","):
        for win in windows:
            for i in range(0, len(seqs), args.scenes_per_thread):
                block = seqs[i:i + args.scenes_per_thread]
                cmd = CHILD + ["--dataset", args.dataset,
                               "--intensity", intensity,
                               "--conflict_strategy", "skip", "--noverbose"]
                if any(block):
                    cmd += ["--sequences", ",".join(block)]
                tag = f"i{intensity}_s{i}"
                if win is not None:
                    cmd += ["--frame_start", str(win[0]),
                            "--frame_end", str(win[1])]
                    tag += f"_f{win[0]}"
                else:
                    # No frame sharding: forward the plain bounds.
                    if f0:
                        cmd += ["--frame_start", str(f0)]
                    if f1 is not None:
                        cmd += ["--frame_end", str(f1)]
                cmd += passthrough
                shards.append((tag, cmd))
    return shards


def child_env() -> dict:
    """The farm's environment with the package's parent directory first
    on PYTHONPATH."""
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": PACKAGE_PARENT + (
        os.pathsep + path if path else "")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", required=True)
    ap.add_argument("-i", "--intensity", default="25")
    ap.add_argument("-s", "--sequences", default="")
    ap.add_argument("--max_threads", type=int, default=4,
                    help="Concurrent child renderers")
    ap.add_argument("--scenes_per_thread", type=int, default=25)
    ap.add_argument("--frames_per_thread", type=int, default=0,
                    help="Also shard each sequence into frame windows of "
                         "this many frames (needs --frame_end). 0 = no "
                         "frame sharding.")
    ap.add_argument("--frame_start", type=int, default=0)
    ap.add_argument("--frame_end", type=int, default=None)
    ap.add_argument("--log_dir", default=".")
    args, passthrough = ap.parse_known_args(argv)

    shards = build_shards(args, passthrough)
    print(f"{len(shards)} shard(s), {args.max_threads} concurrent")

    env = child_env()
    running = []  # (tag, Popen, log_fh, err_fh)
    pending = list(shards)
    failed = []
    while pending or running:
        while pending and len(running) < args.max_threads:
            tag, cmd = pending.pop(0)
            log = open(os.path.join(args.log_dir,
                                    f"automate_log_{tag}.txt"), "w")
            err = open(os.path.join(args.log_dir,
                                    f"automate_error_{tag}.txt"), "w")
            print(f"START {tag}: {' '.join(cmd)}", flush=True)
            running.append((tag, subprocess.Popen(
                cmd, stdout=log, stderr=err, env=env), log, err))
        time.sleep(2)
        still = []
        for tag, proc, log, err in running:
            rc = proc.poll()
            if rc is None:
                still.append((tag, proc, log, err))
                continue
            log.close()
            err.close()
            print(f"END {tag} (exit {rc})", flush=True)
            if rc != 0:
                failed.append(tag)
        running = still

    if failed:
        print(f"{len(failed)} shard(s) failed: {failed} — rerun; 'skip' "
              "strategy resumes where they stopped.")
        return 1
    print("All shards completed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
