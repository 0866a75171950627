"""Output-tree regression diff (reference ``scripts/check_difference.py``).

The port's copy of ``raintpu.tools.check_difference``: compare two
rendered output trees pixel-exactly, report identical/different counts,
per-image mean/std deltas and the top offenders, plus the rain-mask IoU
and an optional JSON report. numpy host code; PIL is imported when a
tree is read.

Usage:
    python -m raintpu_torch.tools.check_difference LEFT RIGHT [--json out.json]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np


def _list_pngs(root: str):
    return sorted(
        p[len(root) + 1:]
        for p in glob.glob(os.path.join(root, "**", "*.png"), recursive=True))


def mask_iou(a: np.ndarray, b: np.ndarray, thresh: float = 0.0) -> float:
    am = a.astype(np.float64).sum(-1) > thresh if a.ndim == 3 else a > thresh
    bm = b.astype(np.float64).sum(-1) > thresh if b.ndim == 3 else b > thresh
    union = (am | bm).sum()
    return 1.0 if union == 0 else float((am & bm).sum() / union)


def compare_trees(left: str, right: str, verbose: bool = True) -> dict:
    from PIL import Image

    p_left = _list_pngs(left)
    p_right = set(_list_pngs(right))

    left_only, identical, different = [], [], []
    diffs = []
    ious = []
    for i, p in enumerate(p_left):
        if verbose and i % 50 == 0:
            print(f"{i}/{len(p_left)}", end="\r")
        if p not in p_right:
            left_only.append(p)
            continue
        a = np.asarray(Image.open(os.path.join(left, p)))
        b = np.asarray(Image.open(os.path.join(right, p)))
        if a.shape == b.shape and np.array_equal(a, b):
            identical.append(p)
        else:
            different.append(p)
            if a.shape == b.shape:
                d = np.abs(a.astype(np.int64) - b.astype(np.int64))
                diffs.append((p, float(d.mean()), float(d.std())))
            if "mask" in p:
                ious.append((p, mask_iou(a, b)))
    right_only = [p for p in p_right if p not in set(p_left)]

    report = {
        "left_only": len(left_only),
        "right_only": len(right_only),
        "identical": len(identical),
        "different": len(different),
    }
    if diffs:
        means = np.asarray([d[1] for d in diffs])
        report["diff_mean_avg"] = float(means.mean())
        report["diff_mean_max"] = float(means.max())
        report["top_offenders"] = sorted(diffs, key=lambda d: -d[1])[:5]
    if ious:
        report["mask_iou_min"] = min(v for _, v in ious)
        report["mask_iou_mean"] = float(np.mean([v for _, v in ious]))

    if verbose:
        print()
        for k, v in report.items():
            print(f"{k}: {v}")
        print("NOTE: small differences may be float rounding only.")
    return report


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("left", nargs="?", default=os.path.join("data", "output"))
    ap.add_argument("right", nargs="?",
                    default=os.path.join("data", "output2"))
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    report = compare_trees(args.left, args.right)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
