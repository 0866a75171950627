"""Prices the raster kernel's per-drop work by knocking it out, one
component at a time, on the card (the port's
``raintpu.tools.kernel_ablation``).

Workload A and its prep as in :mod:`raintpu_torch.tools.kernel_anatomy`.
For each rung of ``--rungs`` (default 0,1) it times a cumulative ladder
of the kernel's compile-time knockouts (``fused_raster_composite(...,
ablate=...)``, ``csrc/fused_raster.cu``'s RAINTPU_ABLATE):

  full                                    the production kernel
  - eval                                  the Chebyshev series and the
                                          tanh-erf window (g a constant
                                          above the cutoff)
  - eval - place                          and the inverse homography
  - eval - accum                          the series, window and the
                                          shared-memory adds
  - eval - accum - write                  and the planes' store to HBM
  - eval - place - accum - write - stage  and the warp's staging of
                                          params and coefficients: what
                                          is left is the residual (slot
                                          scan, list building, headers,
                                          barriers, launch)

Each line's v (us per valid drop) is the slope between n_valid <= 0 and
n_valid <= capacity; the line prints what it saves against the line
before and the price of the component it removes against the line it
extends. The JAX tool's window-read knockouts (noread, nordwait) and its
pair, narrow and row-strip modes have no counterpart on this card: the
kernel sums the planes in shared memory and never reads them.

Then an anchor bracket with the full kernel, the windows moved but not
their content (each slot's P_MINCX/P_MINCY moves with its anchor, so its
texture coordinates and its work stay the same):

  spread  the slots on a grid of the rung's own window size, so that no
          two windows overlap and no barrier separates two drops;
  chain   every slot at one anchor, so that every drop waits behind a
          barrier in the same tiles.

(The JAX tool's spread anchors repeat every 8 slots: they kept only
nearby pipeline steps apart on the TPU. A CUDA block sees every listed
drop of its tile, so they would overlap here.)

A knocked-out kernel renders garbage by design. Every variant is built
up front, one nvcc per variant in parallel, into ``raintpu_torch/
_build/``. Timing needs the card: on the CPU only the helpers run.

Usage:  python -m raintpu_torch.tools.kernel_ablation [--fallrate 10]
            [--rungs 0,1] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from raintpu_torch import cuda_build
from raintpu_torch.ops.fused_raster import (P_MINCX, P_MINCY, RasterRung,
                                            ablate_defines)
from raintpu_torch.tools.kernel_anatomy import (B, cap_valid, launch_ms,
                                                workload)
from raintpu_torch.tools.stage_profile import card_name

# (label, ablate, index of the line it extends, the component removed).
LADDER = (
    ("full", "", None, ""),
    ("- eval", "noeval", 0, "eval"),
    ("- eval - place", "noeval+noplace", 1, "place"),
    ("- eval - accum", "noeval+noaccum", 1, "accum"),
    ("- eval - accum - write", "noeval+noaccum+nowrite", 3, "write"),
    ("- eval - place - accum - write - stage",
     "noeval+noplace+noaccum+nowrite+nostage", 4, "place+stage"),
)
# The chain bracket's one anchor (image x, y), as the JAX tool's.
CHAIN_ANCHOR = (256, 64)


def build_variants() -> list:
    """Every knockout variant of LADDER, one nvcc per variant, all
    started together. Returns the libraries' paths."""
    return cuda_build.build_all(
        ["fused_raster"] * len(LADDER),
        [ablate_defines(ablate) for _, ablate, _, _ in LADDER])


def spread_anchors(n: int, patch_hw, image_hw) -> np.ndarray:
    """(n, 2) int32 image (x, y) anchors on a grid of the (ph, pw)
    window inside the image, row-major; raises ValueError when the grid
    holds fewer than ``n`` windows."""
    ph, pw = patch_hw
    h, w = image_hw
    cols, rows = w // pw, h // ph
    if n > cols * rows:
        raise ValueError(f"spread_anchors: {n} windows of {patch_hw} do not "
                         f"fit a {rows}x{cols} grid of {image_hw}")
    i = np.arange(n)
    return np.stack([(i % cols) * pw, (i // cols) * ph], -1).astype(np.int32)


def windows_overlap(anchors: np.ndarray, patch_hw) -> bool:
    """True when two of the (ph, pw) windows at ``anchors`` (n, 2) share
    a pixel."""
    ph, pw = patch_hw
    x = anchors[:, 0].astype(np.int64)
    y = anchors[:, 1].astype(np.int64)
    meet = ((np.abs(x[:, None] - x[None, :]) < pw)
            & (np.abs(y[:, None] - y[None, :]) < ph))
    np.fill_diagonal(meet, False)
    return bool(meet.any())


def moved_rung(rung: RasterRung, anchors: np.ndarray) -> RasterRung:
    """``rung`` with slot c's window at ``anchors[c]`` in every frame and
    its P_MINCX/P_MINCY moved by as much, so that each window pixel maps
    to the same texture coordinates: the same work, placed elsewhere."""
    new = torch.tensor(np.asarray(anchors), dtype=torch.int32,
                       device=rung.anchor.device)[None].expand_as(
                           rung.anchor).contiguous()
    delta = (new - rung.anchor).to(torch.float32)
    params = rung.params.clone()
    params[:, P_MINCX] += delta[..., 0]
    params[:, P_MINCY] += delta[..., 1]
    return dataclasses.replace(rung, params=params, anchor=new)


def line_v(rung: RasterRung, image_hw, tex_hw, ablate: str = "") -> dict:
    """v of one ladder line: ms at n_valid <= 0 and at every valid slot,
    and the us per valid drop between them."""
    batch = rung.n_valid.shape[0]
    ms0 = launch_ms([cap_valid(rung, 0)], image_hw, tex_hw, ablate)
    ms1 = launch_ms([rung], image_hw, tex_hw, ablate)
    mv = float(rung.n_valid.double().mean())
    return dict(ms0=ms0, ms1=ms1, mean_valid=mv,
                v=(ms1 - ms0) * 1000.0 / (mv * batch) if mv > 0 else None)


def ablation(rungs, buckets, which, image_hw, tex_hw, smi: str = "",
             log=print) -> dict:
    """The ladder and the anchor bracket for each rung index of
    ``which``, printed. Returns {rung index: {"ladder": [line, ...],
    "spread": line, "chain": line}}, each line a :func:`line_v` dict
    (the ladder's with its label, ablate, saves and component price)."""
    out = {}
    for bi in which:
        rung, spec = rungs[bi], buckets[bi]
        cap = rung.params.shape[2]
        log(f"== rung{bi} ({spec.ph},{spec.pw},{spec.radius}) cap={cap}"
            + (f"; on {smi}" if smi else ""))
        lines = []
        for label, ablate, parent, component in LADDER:
            rec = dict(line_v(rung, image_hw, tex_hw, ablate), label=label,
                       ablate=ablate)
            note = ""
            if lines and rec["v"] is not None:
                rec["saves"] = lines[-1]["v"] - rec["v"]
                rec["price"] = lines[parent]["v"] - rec["v"]
                note = (f"  (saves {rec['saves']:+.4f}; {component} "
                        f"{rec['price']:+.4f})")
            lines.append(rec)
            log(f"  {label:<40s} v = {_fmt(rec['v'])} us/drop "
                f"[{rec['ms0']:.4f} -> {rec['ms1']:.4f} ms, mean_valid "
                f"{rec['mean_valid']:.1f}]{note}")
        res = dict(ladder=lines)
        grid = spread_anchors(cap, rung.patch_hw, image_hw)
        if windows_overlap(grid, rung.patch_hw):
            raise AssertionError(f"rung{bi}: spread anchors overlap")
        chain = np.broadcast_to(np.asarray(CHAIN_ANCHOR, np.int32),
                                (cap, 2))
        for mode, anchors in (("spread", grid), ("chain", chain)):
            rec = line_v(moved_rung(rung, anchors), image_hw, tex_hw)
            res[mode] = rec
            log(f"  anchors={mode:<31s} v = {_fmt(rec['v'])} us/drop "
                f"[{rec['ms0']:.4f} -> {rec['ms1']:.4f} ms, mean_valid "
                f"{rec['mean_valid']:.1f}]")
        out[bi] = res
    return out


def _fmt(v) -> str:
    return "  n/a " if v is None else f"{v:6.4f}"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fallrate", type=float, default=10.0,
                    help="mm/hr of workload A (default 10)")
    ap.add_argument("--rungs", default="0,1",
                    help="rung indices of the ladder, comma-separated")
    ap.add_argument("--device", default="cuda",
                    help="Torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: times the kernel on a CUDA card")
    which = [int(r) for r in args.rungs.split(",")]
    build_variants()
    w = workload(args.fallrate, dev)
    print(f"# batch {B}, {args.fallrate:g} mm/hr", flush=True)
    return ablation(w["rungs"], w["cfg"].raster.buckets, which,
                    w["cfg"].image_hw, w["tex_hw"], smi=card_name(),
                    log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
