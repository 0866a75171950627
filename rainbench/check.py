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

Under the online source (:mod:`rainbench.harness`'s ``OnlineDrops``)
the reference renders the drops and picks that each kept output's step
made: the program's own state. So every frame of the kept batches is
also held, by :func:`law`, to what the benchmark's copy of the law
draws on that frame's generator:

- ``sim_mismatch``: drops that differ between the program's valid
  drops and the copy's (each valid drop's fields compared exactly, in
  slot order, plus the difference of the two counts);
- ``picks_mismatch``: valid drops whose texture pick differs from the
  copy of the job's draw;
- ``truncated``: drops the program's own count found lost to the
  simulation capacity, over every step of the run;
- ``law_frames``: the frames compared; ``law_failed_frames``: those
  with a mismatch or whose population the copy finds over the
  simulation capacity.

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


def law(cell: spec.Cell, pool: inputs.Pool, seed: int) -> dict:
    """The online source's drops and picks of every frame of ``pool``
    (the kept steps') against the copy of the simulator's law and of the
    job's picks on the same frame's generators: the copy simulates each
    frame on its own at the simulation capacity, the configuration's
    render scale and the job's exposure, as the program does, so it
    draws the same numbers, and the two agree exactly."""
    t = cell.traffic
    dev = pool.bg.device
    cam = inputs.Camera.from_settings(cell.config["settings"])
    cap = int(t["sim_capacity"])
    rate = torch.full((1,), float(t["fallrate_mm_hr"]), dtype=torch.float32,
                      device=dev)
    expo = inputs.job_exposure_s(cell.config["settings"], 1, dev)
    edges = torch.as_tensor(pool.bin_edges, device=dev)
    n = pool.drops["valid"].shape[-1]
    sims, picks, cut = [], [], []
    for j in range(pool.batches):
        for b, f in enumerate(inputs.online_frames(t, j)):
            fields, count = inputs.simulate(
                inputs.generator(seed, f, dev), cam, cap, rate,
                pool.speeds_mps[j, b:b + 1], expo)
            cut.append(int(count.max()) > cap)
            mine = inputs.compact(fields, cap)
            theirs = {k: v[j, b][None] for k, v in pool.drops.items()}
            packed = inputs.compact(theirs, n)
            n_mine = int(mine["valid"].sum())
            n_prog = int(packed["valid"].sum())
            k = min(n_mine, n_prog)
            differ = torch.zeros(k, dtype=torch.bool, device=dev)
            for name, a in mine.items():
                if name != "valid":
                    differ |= (a[0, :k] != packed[name][0, :k]).reshape(
                        k, -1).any(-1)
            sims.append(abs(n_mine - n_prog) + int(differ.sum()))
            want = inputs.job_picks(seed, f, theirs["ratio"][0], edges)
            picks.append(int(((want != pool.tex_idx[j, b])
                              & theirs["valid"][0]).sum()))
    return {"sim_mismatch": sum(sims), "picks_mismatch": sum(picks),
            "law_frames": len(sims),
            "law_failed_frames": sum(a + b > 0 or c
                                     for a, b, c in zip(sims, picks, cut))}


def numbers(cell: spec.Cell, pool: inputs.Pool, kept: list, seed: int,
            truncated=None):
    """(numbers, per-frame largest gaps {name: list}) of the kept
    outputs against the reference; under the online source, also
    :func:`law`'s and the program's ``truncated`` count."""
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
    if inputs.drop_source(t) == "online":
        got.update(law(cell, pool, seed))
        got["truncated"] = math.inf if truncated is None else truncated
    return got, per_frame


def judge(cell: spec.Cell, pool: inputs.Pool, kept: list, seed: int,
          truncated=None) -> Verdict:
    """The verdict on the kept outputs; ``truncated``: the online
    source's count of drops lost to the simulation capacity."""
    got, per_frame = numbers(cell, pool, kept, seed, truncated)
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
    if {"sim_mismatch", "picks_mismatch", "truncated"} & set(held):
        failed += got["law_failed_frames"]
    return Verdict(correct=correct, failed=failed, checks=checks,
                   numbers=got)
