"""Reference-format particle-XML interchange: reader, writer, cache.

The port's copy of ``raintpu.particles.xml_io``. The integration
contract of the reference (SURVEY.md §1) is the per-sequence,
per-fallrate XML file ``*_camera0.xml``: ``<frame id t d rs>`` elements
whose ``<drop>`` children carry ``pid, wp1, wp2, wd1, wd2, ip1, ip2,
iw1, iw2`` (world/image positions "(x;y[;z])" and diameters) — consumed
at ``common/bad_weather.py:148-248``. This module reads and *writes*
that format, so precomputed simulations from the reference ecosystem
drop in, and the port's simulator can export its output for the
reference renderer.

The reader mirrors the reference's md5-validated pickle cache
(``bad_weather.py:155-178``) with a content-hashed ``.npz`` (versioned,
image-shape-keyed, safe against corrupted XML with an actionable
error), in the JAX package's format: either package reads the other's
cache. The native C++ parser (:mod:`raintpu_torch.particles.native`)
takes cold parses when it builds; ElementTree otherwise.
:func:`parse_particles_xml_raw` counts which parser ran.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional
from xml.etree.ElementTree import Element, ElementTree, SubElement
from xml.etree.ElementTree import parse as xml_parse

import numpy as np

from raintpu_torch.particles import native
from raintpu_torch.particles.schema import (DropBatch, cull_to_frame,
                                            finalize_raw_streaks,
                                            pack_drop_batch)

CACHE_VERSION = "raintpu-1"


def _file_md5(path: str) -> str:
    hasher = hashlib.md5()
    with open(path, "rb") as fh:
        hasher.update(fh.read())
    return hasher.hexdigest()


def _vec(text: str) -> np.ndarray:
    return np.asarray([float(v) for v in text[1:-1].split(";")])


def parse_particles_xml_raw(path: str, prefer_native: bool = True
                            ) -> List[dict]:
    """Parse an XML simulation into raw per-frame records (sim-space).

    Returns a list of dicts with keys: id, exposure, start, count, and
    raw arrays pid, ip1, ip2 (M, 2), iw1, iw2, wd1, wd2 (M,), wp1, wp2
    (M, 3) in simulator conventions (no flips applied). Uses the native
    C++ parser when it builds, ElementTree otherwise; either raises a
    RuntimeError that says "corrupted" on a malformed file.
    ``parse_particles_xml_raw.parses`` counts the parses by parser
    ("native", "python").
    """
    if prefer_native and native.available():
        frames = native.parse_particles_xml_native(path)
        parse_particles_xml_raw.parses["native"] += 1
        return frames
    try:
        root = xml_parse(path).getroot()
    except Exception as e:
        raise RuntimeError(
            f"Reading XML file {path} failed ({e}); likely a corrupted "
            "particle simulation — delete the simulation folder and re-run "
            "to regenerate.") from e

    frames = []
    for frame in root:
        a = frame.attrib
        n = len(frame)
        ip1 = np.zeros((n, 2)); ip2 = np.zeros((n, 2))
        iw1 = np.zeros((n,)); iw2 = np.zeros((n,))
        wd1 = np.zeros((n,)); wd2 = np.zeros((n,))
        wp1 = np.zeros((n, 3)); wp2 = np.zeros((n, 3))
        pid = np.zeros((n,), np.int64)
        for i, drop in enumerate(frame):
            d = drop.attrib
            pid[i] = int(d["pid"])
            wp1[i] = _vec(d["wp1"])
            wp2[i] = _vec(d["wp2"])
            ip1[i] = _vec(d["ip1"])
            ip2[i] = _vec(d["ip2"])
            iw1[i] = float(d["iw1"])
            iw2[i] = float(d["iw2"])
            wd1[i] = float(d.get("wd1", 0.0))
            wd2[i] = float(d.get("wd2", 0.0))
        frames.append({
            "id": int(a["id"]), "exposure": int(a["t"]),
            "start": int(a["d"]), "count": int(a.get("rs", n)),
            "pid": pid, "ip1": ip1, "ip2": ip2, "iw1": iw1, "iw2": iw2,
            "wp1": wp1, "wp2": wp2, "wd1": wd1, "wd2": wd2,
        })
    parse_particles_xml_raw.parses["python"] += 1
    return frames


parse_particles_xml_raw.parses = {"native": 0, "python": 0}


def load_streaks(path: str,
                 image_wh,
                 render_scale: float = 1.0,
                 dataset: Optional[str] = None,
                 use_cache: bool = True,
                 cull: bool = True) -> Dict[int, dict]:
    """XML -> {frame_id: finalized streak record} with npz caching.

    Applies the same derivations as the reference parse
    (``bad_weather.py:200-239``): render-scale division (or the
    ``nuscenes_gan`` resolution rescale), y-flip, z-negation,
    width/length/ratio/type, degenerate filtering; plus (optionally) the
    in-frame culling the reference does per frame (``generator.py:413``).
    """
    rescale = None
    if dataset == "nuscenes_gan":
        # Simulation at 1600x900; rendering at image_wh
        # (bad_weather.py:213-219).
        rescale = float(np.mean([image_wh[0] / 1600.0, image_wh[1] / 900.0]))

    cache_path = path + ".npz"
    sim_hash = _file_md5(path)
    meta_key = json.dumps([CACHE_VERSION, sim_hash, list(map(int, image_wh)),
                           float(render_scale), rescale, bool(cull)])
    if use_cache and os.path.exists(cache_path):
        try:
            data = np.load(cache_path, allow_pickle=False)
            if str(data["meta_key"]) == meta_key:
                n_frames = int(data["n_frames"])
                out = {}
                for i in range(n_frames):
                    fid = int(data[f"f{i}_id"])
                    out[fid] = {k: data[f"f{i}_{k}"] for k in
                                ("ip1", "ip2", "iw1", "iw2", "wp1", "wp2",
                                 "max_width", "length", "ratio", "drop_type")}
                return out
        except Exception:
            pass  # stale/corrupt cache -> regenerate

    frames = parse_particles_xml_raw(path)
    out = {}
    arrays = {"meta_key": np.asarray(meta_key),
              "n_frames": np.asarray(len(frames))}
    for i, f in enumerate(frames):
        rec = finalize_raw_streaks(
            f["ip1"], f["ip2"], f["iw1"], f["iw2"], f["wp1"], f["wp2"],
            image_wh, render_scale=render_scale, rescale=rescale)
        if cull:
            rec = cull_to_frame(rec, image_wh)
        out[f["id"]] = rec
        arrays[f"f{i}_id"] = np.asarray(f["id"])
        for k, v in rec.items():
            arrays[f"f{i}_{k}"] = v

    if use_cache:
        try:
            np.savez_compressed(cache_path, **arrays)
        except OSError:
            pass  # read-only particle dir — cache is best-effort
    return out


def write_particles_xml(path: str, frames: List[dict]) -> None:
    """Write raw sim-space frame records in the reference XML format.

    Frames as produced by :func:`parse_particles_xml_raw` (or by
    :func:`batch_to_raw_frames` from simulator output).
    """
    root = Element("simulation")
    for f in frames:
        n = len(f["ip1"])
        fr = SubElement(root, "frame", {
            "id": str(int(f["id"])), "t": str(int(f.get("exposure", 0))),
            "d": str(int(f.get("start", 0))), "rs": str(n)})
        pid = f.get("pid")
        for i in range(n):
            SubElement(fr, "drop", {
                "pid": str(int(pid[i]) if pid is not None else i),
                "wp1": "({:.6g};{:.6g};{:.6g})".format(*f["wp1"][i]),
                "wp2": "({:.6g};{:.6g};{:.6g})".format(*f["wp2"][i]),
                "wd1": "{:.6g}".format(float(f.get("wd1", f["iw1"])[i])),
                "wd2": "{:.6g}".format(float(f.get("wd2", f["iw2"])[i])),
                "ip1": "({:.6g};{:.6g})".format(*f["ip1"][i]),
                "ip2": "({:.6g};{:.6g})".format(*f["ip2"][i]),
                "iw1": "{:.6g}".format(float(f["iw1"][i])),
                "iw2": "{:.6g}".format(float(f["iw2"][i])),
            })
    ElementTree(root).write(path)


def batch_to_raw_frames(batch: DropBatch, image_wh, cam_hz: float,
                        exposure_s: float,
                        render_scale: float = 1.0,
                        focal_px: Optional[float] = None) -> List[dict]:
    """Convert simulator DropBatch output (parsed convention, on any
    device, with or without a leading frame dim) back to raw sim-space
    records for XML export.

    ``image_wh`` is the FULL-resolution camera size (e.g.
    ``SimConfig.image_wh``); batch positions are render-space, so the
    inverse transform is ``y_sim = H_full - y_render * render_scale``.
    Inverts the parse conventions: image y unflipped to bottom-origin
    full-res, world z negated back. Rounded image positions are kept
    (lossless through a re-parse round-trip). When ``focal_px`` is
    given, world diameters (wd1/wd2, meters) are derived via the
    thin-lens relation wd = iw_fullres * depth / focal."""
    h = int(image_wh[1])

    def host(t):
        return t.detach().cpu().numpy()

    ip1, ip2, iw1, iw2, wp1, wp2, valid = (host(t) for t in (
        batch.ip1, batch.ip2, batch.iw1, batch.iw2, batch.wp1, batch.wp2,
        batch.valid))
    if ip1.ndim == 2:
        ip1, ip2, iw1, iw2, wp1, wp2, valid = (
            a[None] for a in (ip1, ip2, iw1, iw2, wp1, wp2, valid))
    frames = []
    for fi in range(ip1.shape[0]):
        v = valid[fi]
        rs = render_scale

        def unflip(p):
            q = p[v] * rs
            return np.stack([q[:, 0], h - q[:, 1]], -1)

        wp1_s = wp1[fi][v].copy(); wp1_s[:, 2] *= -1
        wp2_s = wp2[fi][v].copy(); wp2_s[:, 2] *= -1
        if focal_px is not None:
            # depth = world z forward (positive in parsed convention).
            wd1_s = iw1[fi][v] * rs * np.abs(wp1[fi][v][:, 2]) / focal_px
            wd2_s = iw2[fi][v] * rs * np.abs(wp2[fi][v][:, 2]) / focal_px
        else:
            wd1_s = np.zeros(int(v.sum()))
            wd2_s = np.zeros(int(v.sum()))
        frames.append({
            "id": fi, "exposure": int(exposure_s * 1e6),
            "start": int(fi / cam_hz * 1e6), "pid": np.arange(v.sum()),
            "ip1": unflip(ip1[fi]), "ip2": unflip(ip2[fi]),
            "iw1": iw1[fi][v] * rs, "iw2": iw2[fi][v] * rs,
            "wp1": wp1_s, "wp2": wp2_s,
            "wd1": wd1_s, "wd2": wd2_s,
        })
    return frames


def streaks_to_batches(streaks: Dict[int, dict], capacity: int,
                       device=None):
    """{frame_id: record} -> (ordered ids, list of DropBatch on
    ``device``, None: the CUDA card)."""
    ids = sorted(streaks)
    return ids, [pack_drop_batch(streaks[i], capacity, device) for i in ids]
