"""Online rendering: particles simulated on the card, no XML files.

Counterpart of ``raintpu.render.online``: each frame's rain is
simulated by :mod:`raintpu_torch.physics.simulator` straight into the
renderer's drop schema. Frame i draws from its own generator
(:func:`~raintpu_torch.physics.simulator.frame_generator` of
(seed, i)), so its drops do not depend on the batch it is simulated in,
and the drops lost to the simulation capacity are counted exactly by
replaying the count draw. With ``export_xml`` the job also keeps every
frame's simulation (before compaction) and :meth:`finish_export` writes
it as reference-format XML (``--export_xml``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raintpu_torch.data import db as db_mod
from raintpu_torch.particles import xml_io
from raintpu_torch.particles.schema import compact_drop_batch
from raintpu_torch.physics.simulator import (SimConfig, frame_generator,
                                             schedule_from_settings,
                                             simulate_frame,
                                             simulate_frames_keyed,
                                             truncated_counts)
from raintpu_torch.render.camera import settings_from_dict
from raintpu_torch.render.pipeline import RenderJob
from raintpu_torch.utils.logging import print_warning


class OnlineRenderJob(RenderJob):
    """RenderJob whose drop source is the simulator on the job's device."""

    export_xml: bool = False

    def _setup_drop_source(self, seq, w_i, weather, hw) -> None:
        s = self.spec
        rsettings = settings_from_dict(s.settings)
        # Per-sequence sim overrides (regex-matched), like db.sim.
        try:
            sim_spec = db_mod.sim(s.dataset, seq, "")
            rsettings = settings_from_dict(sim_spec["options"])
        except ImportError:
            pass

        self._sim_cfg = SimConfig.from_settings(
            rsettings, capacity=s.drop_capacity)
        (self._sched_fall, self._sched_speed, self._sched_expo,
         self._sched_focal) = schedule_from_settings(
            rsettings, weather["fallrate"])
        self._sim_seed = s.seed
        self._trunc_seen = set()
        self._render_cap = None
        self._export_frames = None
        if self.export_xml:
            if not hasattr(self, "_exports"):
                self._exports = {}
            key = (seq, weather["weather"], weather["fallrate"])
            self._export_frames = self._exports.setdefault(key, {})

    def _generator(self, frame_idx: int) -> torch.Generator:
        return frame_generator(self._sim_seed, frame_idx, self.device)

    def _drops_for_frame(self, frame_idx: int):
        """One frame's simulation on its own (N, ...) — the same drops as
        that frame of a batched simulation."""
        i = frame_idx % len(self._sched_fall)
        batch = simulate_frame(
            self._generator(frame_idx), self._sim_cfg,
            float(self._sched_fall[i]), float(self._sched_speed[i]),
            float(self._sched_expo[i]), float(self._sched_focal[i]),
            device=self.device)
        self._count_truncation([frame_idx])
        self._record_export(frame_idx, batch, i)
        return batch

    def _record_export(self, frame_idx: int, batch, sched_i: int) -> None:
        """Keep one frame's simulation (N, ...) as a raw XML record."""
        if self._export_frames is None or frame_idx in self._export_frames:
            return
        raw = xml_io.batch_to_raw_frames(
            batch, self._sim_cfg.image_wh,
            cam_hz=self._sim_cfg.cam_hz,
            exposure_s=float(self._sched_expo[sched_i]),
            render_scale=self._sim_cfg.render_scale,
            focal_px=float(self._sim_cfg.focal_px[0]))
        raw[0]["id"] = frame_idx
        self._export_frames[frame_idx] = raw[0]

    def _count_truncation(self, frame_indices) -> None:
        """Add the drops the capacity clamp lost in frames not counted
        yet (batch padding repeats a frame)."""
        new = [fi for fi in dict.fromkeys(frame_indices)
               if fi not in self._trunc_seen]
        if not new:
            return
        sched = np.asarray([fi % len(self._sched_fall) for fi in new])
        trunc = truncated_counts(
            [self._generator(fi) for fi in new], self._sim_cfg,
            torch.as_tensor(self._sched_fall[sched], device=self.device))
        self._trunc_seen.update(new)
        self._truncated_total += int(trunc.sum())

    def _compact_for_render(self, batch):
        """Pack valid drops to the front and trim the per-drop axis before
        rendering.

        The simulator's capacity must hold the population before the
        in-frame culls, but only about half of it survives them, and the
        per-drop prep scales with the capacity it is handed. The render
        capacity is fitted from the first batch's largest valid count
        (x1.3 + 64, 128-aligned, at most the sim capacity); a later batch
        that exceeds it refits the capacity upward rather than dropping
        drops, which would silently change the frame's content."""
        sim_cap = batch.valid.shape[-1]
        vmax = int(batch.count().max())

        def fit(n_valid: int) -> int:
            cap = int(n_valid * 1.3) + 64
            return min(-(-cap // 128) * 128, sim_cap)

        if self._render_cap is not None and vmax > self._render_cap:
            print_warning(
                f"a batch holds {vmax} valid drops, over the fitted "
                f"render capacity ({self._render_cap}); refitting to "
                f"{fit(vmax)}.")
            self._render_cap = None
        if self._render_cap is None:
            self._render_cap = fit(vmax)
        if self._render_cap >= sim_cap:
            return batch
        return compact_drop_batch(batch, self._render_cap)

    def _drops_for_frames(self, frame_indices):
        return self._compact_for_render(self._simulate_batch(frame_indices))

    def _simulate_batch(self, frame_indices):
        """All frames of a batch, each on its own generator (the same
        drops as :meth:`_drops_for_frame` gives that frame)."""
        sched = np.asarray([fi % len(self._sched_fall)
                            for fi in frame_indices])

        def col(a):
            return torch.as_tensor(a[sched], device=self.device)

        batch = simulate_frames_keyed(
            [self._generator(fi) for fi in frame_indices], self._sim_cfg,
            col(self._sched_fall), col(self._sched_speed),
            col(self._sched_expo), col(self._sched_focal))
        self._count_truncation(frame_indices)
        if self._export_frames is not None:
            for b, fi in enumerate(frame_indices):
                self._record_export(fi, batch.map(lambda t: t[b]),
                                    int(sched[b]))
        return batch

    def finish_export(self, root_dir: str):
        """Write the kept simulations as reference-format XML under
        ``root_dir/SEQ/WEATHER/{N}mm/0000_camera0.xml`` (the layout the
        offline mode reads particle files from, my_utils.py:172-173).
        Returns the list of written paths."""
        paths = []
        for (seq, weather, fallrate), frames in \
                getattr(self, "_exports", {}).items():
            d = os.path.join(root_dir, seq, weather, f"{fallrate}mm")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, "0000_camera0.xml")
            xml_io.write_particles_xml(
                path, [frames[k] for k in sorted(frames)])
            paths.append(path)
        return paths
