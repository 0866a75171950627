"""Whether what the window produced is right: the program's kept
outputs against the plain reference (:mod:`rainbench.reference`).

For every pool batch the window rendered, its latest output is judged
on a sample of its frames drawn from the run's seed, the frame with the
most drops always among them. The reference renders those frames from
the same inputs in blocks, once the program is freed. The numbers:

- ``mask_max``: the largest |program - reference| of the rain mask;
- ``image_max`` and ``image_mean``: the largest and the mean
  |program - reference| of the rainy image's channels;
- ``envmap_max``: the largest |program - reference| of the envmap,
  where the run saves envmaps;
- ``overflow``: drops the program's rungs dropped, over every frame of
  the kept outputs (the drop accounting);
- ``frames``: the frames judged; ``overflow_frames``: the kept frames
  that dropped a drop.

The cell's limits file says which numbers are held, each to its limit:
a number above its limit, or not finite, makes the run not correct. A
frame whose own largest gap of a held ``*_max`` number is over its
limit counts as failed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rainbench import inputs, spec
from rainbench.reference.render import Reference


@dataclasses.dataclass
class Verdict:
    correct: bool
    failed: int
    checks: dict    # name -> {"value", "limit"}: the numbers held
    numbers: dict   # every number worked out


def _gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| per element, not-finite as inf."""
    return torch.nan_to_num((a.to(torch.float32) - b).abs(), nan=math.inf,
                            posinf=math.inf)


def sample(pool: inputs.Pool, batches: int, per_batch: int, seed: int):
    """Frames judged of each batch: the one with the most drops and
    ``per_batch - 1`` others drawn from the seed, ascending."""
    rng = np.random.default_rng(inputs.sub_seed(seed, inputs.STREAM_CHECK))
    counts = pool.drops["valid"].sum(-1).cpu().numpy()
    n_b = counts.shape[1]
    out = []
    for j in range(batches):
        heavy = int(counts[j].argmax())
        rest = [b for b in range(n_b) if b != heavy]
        k = min(per_batch - 1, len(rest))
        out.append(sorted({heavy, *rng.choice(rest, k, replace=False)
                           .tolist()}))
    return out


def numbers(cell: spec.Cell, pool: inputs.Pool, kept: list, seed: int):
    """(numbers, per-frame largest gaps {name: list}) of the kept
    outputs against the reference."""
    t = cell.traffic
    ref = Reference(cell.config["settings"], t["fallrate_mm_hr"],
                    cell.config["render"]["cone_downsample"],
                    t["save_envmap"], pool)
    block = int(t["reference_block_frames"])
    per_frame = {"mask_max": [], "image_max": [], "envmap_max": []}
    img_sum = 0.0
    img_n = 0
    envmap = bool(t["save_envmap"])
    for j, idx in enumerate(sample(pool, len(kept), int(
            t["check_frames_per_batch"]), seed)):
        out = kept[j]
        for c in range(0, len(idx), block):
            part = idx[c:c + block]
            r = ref.render(*pool.frames(j, part))
            ix = torch.as_tensor(part, device=pool.bg.device)
            dm = _gap(out.rain_mask[ix], r["rain_mask"])
            di = _gap(out.rainy_image[ix], r["rainy_image"])
            per_frame["mask_max"] += dm.flatten(1).amax(1).tolist()
            per_frame["image_max"] += di.flatten(1).amax(1).tolist()
            img_sum += float(di.double().sum())
            img_n += di.numel()
            if envmap:
                de = _gap(out.envmap[ix], r["envmap"])
                per_frame["envmap_max"] += de.flatten(1).amax(1).tolist()
            del r, dm, di
    got = {k: max(v) for k, v in per_frame.items() if v}
    got["image_mean"] = img_sum / img_n if img_n else math.inf
    got["overflow"] = sum(int(o.overflow.sum()) for o in kept)
    got["overflow_frames"] = sum(int((o.overflow.sum(-1) > 0).sum())
                                 for o in kept)
    got["frames"] = len(per_frame["mask_max"])
    got["ladder"] = [[b.ph, b.pw, b.radius, b.modes_y, b.modes_x, b.ranks]
                     for b in ref.ladder]
    return got, per_frame


def judge(cell: spec.Cell, pool: inputs.Pool, kept: list,
          seed: int) -> Verdict:
    got, per_frame = numbers(cell, pool, kept, seed)
    held = cell.limits["numbers"]
    checks = {}
    correct = got["frames"] > 0
    for name, lim in held.items():
        v = float(got.get(name, math.inf))
        checks[name] = {"value": v, "limit": float(lim["limit"])}
        if not v <= lim["limit"]:
            correct = False
    bad = np.zeros(got["frames"], bool)
    for name, gaps in per_frame.items():
        if name in held and gaps:
            bad |= ~(np.asarray(gaps) <= held[name]["limit"])
    failed = int(bad.sum()) + (got["overflow_frames"] if "overflow" in held
                               else 0)
    return Verdict(correct=correct, failed=failed, checks=checks,
                   numbers=got)
