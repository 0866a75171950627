"""Sequence/weather/frame orchestration — the host-side render driver.

Counterpart of ``raintpu.render.pipeline``: frames are batched, loaded
on a thread pool while the card renders, rendered a batch at a time by
:func:`raintpu_torch.render.frame.render_frames`, and saved on a thread
pool. Behaviours kept from the reference and the JAX job:

- conflict strategies ``overwrite|skip|rename_folder`` at folder and
  frame granularity — the file-keyed idempotency that doubles as
  crash-resume;
- per-frame determinism: frame i's texture picks, then its streak
  noise, come from a generator seeded ``seed * 100003 + i`` (the JAX
  job's ``PRNGKey`` of the same number), so a frame's output depends
  neither on ``--frame_start`` nor on the batch it is rendered in;
- output layout ``OUT/DATASET[_strategy]/SEQ/rain/{N}mm/{rainy_image,
  rain_mask[, saturation_mask]}/NAME.{png,npy}`` plus a sequence-level
  ``envmap/``.

The job renders on ``JobSpec.device`` (the CUDA card unless the caller
asks for the CPU). Its drop source is the weather's particle XML file
(:mod:`raintpu_torch.particles.xml_io`), packed on the host a batch at
a time and moved to the device once per batch;
:mod:`raintpu_torch.render.online` replaces it with the simulator.
:meth:`RenderJob.run`'s stats give, in ``stage_ms``, the median host ms
a batch inside each stage span of the render
(:data:`raintpu_torch.render.frame.STAGES`).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from raintpu_torch.data import io as data_io
from raintpu_torch.data.textures import (StreakDatabase, get_streak_database,
                                         texture_bank)
from raintpu_torch.ops.rasterize import (BucketSpec, RasterConfig,
                                         fit_raster_config, select_textures)
from raintpu_torch.particles import xml_io
from raintpu_torch.particles.schema import pack_drop_batches
from raintpu_torch.render.camera import RenderSettings, settings_from_dict
from raintpu_torch.render.frame import STAGES, PipelineConfig, render_frames
from raintpu_torch.utils import profiling
from raintpu_torch.utils.logging import (ProgressScope, natural_listdir,
                                         print_warning)


@dataclasses.dataclass
class JobSpec:
    """One rendering job (the reference's parsed-args surface)."""

    dataset: str
    sequences: Sequence[str]
    images: Dict[str, object]       # seq -> dir or file list
    depth: Dict[str, object]
    calib: Dict[str, object]
    particles: Dict[str, List[str]]  # seq -> XML path per weather
    weather: List[dict]              # [{"weather": "rain", "fallrate": i}]
    settings: dict                   # reference-style settings dict
    output_root: str
    streaks_db: Optional[str] = None
    norm_coeff: Optional[str] = None
    conflict_strategy: Optional[str] = None
    rendering_strategy: Optional[str] = None
    save_envmap: bool = False
    # Compute + save the reference's rainy_saturation_mask
    # (bad_weather.py:450-460; it accumulates one per frame).
    save_saturation: bool = False
    # Environment-map source: 'ours' extrapolates from the frame
    # (generator.py:400); 'pano' loads a captured panorama per frame
    # from panos_dir/<frame-file-name> (generator.py:401-403, which
    # reads data/panos/<file_name>).
    env_type: str = "ours"
    panos_dir: Optional[str] = None
    frame_start: int = 0
    frame_end: Optional[int] = None
    frame_step: int = 1
    frames: Optional[List[int]] = None
    noise_scale: float = 0.0
    noise_std: float = 0.0
    opacity_attenuation: float = 1.0
    verbose: bool = True
    batch_size: int = 4
    drop_capacity: int = 2048
    seed: int = 0
    # default: the fixed 4-rung RasterConfig.default ladder; fitted: a
    # ladder fitted to the first 8 frames' drops of the weather
    # (ops.rasterize.fit_raster_config); tiny: minimal buckets for tests
    # and smoke runs.
    raster_profile: str = "default"   # default | fitted | tiny
    # Block-reduction of the cone-photometry envmap features
    # (PipelineConfig.cone_downsample); 1 = exact.
    cone_downsample: int = 4
    # Output encoding: 'png' (the reference's output contract, needs PIL
    # and matplotlib) or 'npy' raw arrays (rainy uint8, mask float32).
    save_format: str = "png"
    # Where the job renders: the CUDA card unless the caller asks for
    # the CPU (where every kernel runs its plain PyTorch version).
    device: str = "cuda"


class RenderJob:
    def __init__(self, spec: JobSpec):
        self.spec = spec
        self.device = torch.device(spec.device)
        self.db: Optional[StreakDatabase] = None
        self._resolve_conflict_strategy()
        self._overflow_total = 0
        self._truncated_total = 0
        self._batches = 0

    # -- conflict handling ------------------------------------------------
    def _existing_output_dirs(self) -> List[str]:
        s = self.spec
        out = []
        for seq in s.sequences:
            for w in s.weather:
                d = os.path.join(self._output_root(), seq, w["weather"],
                                 f'{w["fallrate"]}mm')
                if os.path.exists(d):
                    out.append(d)
        return out

    def _resolve_conflict_strategy(self) -> None:
        s = self.spec
        existing = self._existing_output_dirs()
        if existing and s.conflict_strategy is None:
            print("\nOutput folders already exist:\n  " +
                  "\n  ".join(existing))
            if sys.stdin.isatty():
                while s.conflict_strategy not in ("overwrite", "skip",
                                                  "rename_folder"):
                    s.conflict_strategy = input(
                        "Strategy (overwrite|skip|rename_folder): ").strip()
            else:
                print_warning("Non-interactive session: using 'skip'.")
                s.conflict_strategy = "skip"
        if s.conflict_strategy not in (None, "overwrite", "skip",
                                       "rename_folder"):
            raise ValueError(
                f"Unknown conflict strategy {s.conflict_strategy!r}")

    def _output_root(self) -> str:
        s = self.spec
        name = s.dataset if s.rendering_strategy is None else \
            f"{s.dataset}_{s.rendering_strategy}"
        return os.path.join(s.output_root, name)

    # -- inputs -----------------------------------------------------------
    def _frame_files(self, seq: str):
        s = self.spec
        images = s.images[seq]
        if isinstance(images, (list, tuple, np.ndarray)):
            files = list(images)
        else:
            files = [os.path.join(images, f)
                     for f in natural_listdir(images)]
        depths = s.depth[seq]
        if isinstance(depths, (list, tuple, np.ndarray)):
            dfiles = list(depths)
        else:
            dfiles = [os.path.join(depths, f)
                      for f in natural_listdir(depths)]
        return files, dfiles

    def _frame_indices(self, n_files: int) -> List[int]:
        s = self.spec
        f_end = n_files if s.frame_end is None else min(s.frame_end, n_files)
        if s.frames:
            return np.unique(np.clip(s.frames, 0, f_end - 1)).tolist()
        return list(range(s.frame_start, f_end, s.frame_step))

    def _render_settings(self) -> RenderSettings:
        s = self.spec
        rs = settings_from_dict(s.settings)
        return dataclasses.replace(
            rs, noise_scale=s.noise_scale, noise_std=s.noise_std,
            opacity_attenuation=s.opacity_attenuation,
            rendering_strategy=s.rendering_strategy,
            env_type=s.env_type)

    def _load_pano(self, image_file: str) -> np.ndarray:
        """Captured panorama for a frame (env_type='pano'): the file of
        the same name under panos_dir (reference generator.py:401-403)."""
        s = self.spec
        if not s.panos_dir:
            raise ValueError("env_type='pano' requires panos_dir")
        path = os.path.join(s.panos_dir, os.path.basename(image_file))
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.float32) / 255.0

    def _pipeline_config(self, rsettings, hw, fallrate, tex_hw,
                         n_files: int) -> PipelineConfig:
        s = self.spec
        kw = dict(save_envmap=s.save_envmap,
                  compute_saturation_mask=s.save_saturation,
                  cone_downsample=s.cone_downsample)
        if s.raster_profile == "tiny":
            # Two small rungs for tests and smoke runs.
            raster = RasterConfig(
                buckets=(BucketSpec(32, 24, 4, s.drop_capacity),
                         BucketSpec(64, 48, 8, 16)),
                supersample=1)
            return PipelineConfig(
                settings=rsettings, image_hw=tuple(hw),
                fallrate=float(fallrate), raster=raster, env_downsample=8,
                **kw)
        if s.raster_profile == "fitted":
            # Fit the ladder to the drops of the weather's first frames,
            # from the drop source just set up; the overflow counters
            # still warn if later frames outgrow the fit.
            sample = self._drops_for_frames(list(range(min(8, n_files))))
            raster = fit_raster_config(sample, tex_hw, (hw[1], hw[0]),
                                       rsettings)
            return PipelineConfig(
                settings=rsettings, image_hw=tuple(hw),
                fallrate=float(fallrate), raster=raster, **kw)
        if s.raster_profile != "default":
            raise ValueError(f"raster_profile={s.raster_profile!r}: "
                             "expected 'default', 'fitted' or 'tiny'")
        return PipelineConfig.build(rsettings, hw, fallrate,
                                    drop_capacity=s.drop_capacity, **kw)

    # -- output -----------------------------------------------------------
    @staticmethod
    def _save_rainy(path: str, rainy: np.ndarray) -> None:
        arr = (np.clip(rainy, 0, 1) * 255).round().astype(np.uint8)
        if path.endswith(".npy"):
            np.save(path, arr)
            return
        from PIL import Image

        Image.fromarray(arr).save(path)

    @staticmethod
    def _save_mask_npy(path: str, mask: np.ndarray) -> None:
        np.save(path, np.asarray(mask, np.float32))

    @staticmethod
    def _save_mask(path: str, mask: np.ndarray) -> None:
        # Colormapped normalized PNG, like plt.imsave of a 2-D array
        # (generator.py:467) ...
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, mask)
        # ... plus a lossless 16-bit grayscale companion for metrics.
        from PIL import Image

        raw = np.clip(mask / max(float(mask.max()), 1e-9), 0, 1)
        Image.fromarray((raw * 65535).astype(np.uint16)).save(
            path.replace(".png", "_raw.png"))

    # -- main loop --------------------------------------------------------
    def run(self) -> dict:
        s = self.spec
        t_start = time.perf_counter()
        stats = {"rendered": 0, "skipped": 0, "failed": 0}
        self._batches = 0
        self.db = get_streak_database(s.streaks_db, s.norm_coeff,
                                      seed=s.seed)
        textures = texture_bank(self.db, device=self.device)
        edges = torch.as_tensor(self.db.bin_edges, device=self.device)
        if s.save_format not in ("png", "npy"):
            raise ValueError(
                f"save_format={s.save_format!r}: expected 'png' or 'npy'")
        ext = "." + s.save_format

        prog = ProgressScope(["sequence", "weather", "frame"])
        prog.start("sequence", len(s.sequences))
        # Saves run on a thread pool: PNG encode costs ~5-10 ms per frame
        # on the host, which would otherwise hold the card back.
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            saves = []
            for seq_i, seq in enumerate(s.sequences):
                prog.update("sequence", seq_i)
                prog.start("weather", len(s.weather))
                files, dfiles = self._frame_files(seq)
                for w_i, weather in enumerate(s.weather):
                    prog.update("weather", w_i)
                    self._render_weather(seq, w_i, weather, files, dfiles,
                                         ext, textures, edges, prog, stats,
                                         pool, saves)
            # Drain pending saves; surface any I/O error.
            for fut in saves:
                fut.result()
        stats["overflowed_drops"] = self._overflow_total
        stats["truncated_drops"] = self._truncated_total
        # Disk-to-disk throughput: wall time of the whole run() (reads,
        # render, kernel builds, encode + writes) over frames rendered.
        elapsed = time.perf_counter() - t_start
        stats["elapsed_s"] = round(elapsed, 2)
        if stats["rendered"] and elapsed > 0:
            stats["img_per_s"] = round(stats["rendered"] / elapsed, 2)
        # The host's time in each stage of a batch's render, from the
        # spans of the job's batches.
        stats["stage_ms"] = {
            name: round(statistics.median(ms), 3) for name in STAGES
            if (ms := profiling.stage_ms(name, self._batches))}
        if self._truncated_total:
            print_warning(
                f"{self._truncated_total} drop(s) were truncated at "
                "simulation time (population larger than --drop_capacity).")
        return stats

    def _render_weather(self, seq, w_i, weather, files, dfiles, ext,
                        textures, edges, prog, stats, pool, saves) -> None:
        s = self.spec
        fallrate = weather["fallrate"]
        out_seq = os.path.join(self._output_root(), seq)
        out_dir = os.path.join(out_seq, weather["weather"], f"{fallrate}mm")
        if os.path.exists(out_dir) and s.conflict_strategy == "rename_folder":
            i = 0
            while os.path.exists(out_dir + "_copy%05d" % i):
                i += 1
            out_dir = out_dir + "_copy%05d" % i
        os.makedirs(out_dir, exist_ok=True)

        render_scale = int(s.settings["render_scale"])
        depth_scale = int(s.settings["depth_scale"])
        first = data_io.load_frame(files[0], dfiles[0], render_scale,
                                   depth_scale)
        if first is None:
            print_warning(f"Sequence {seq}: first depth missing")
            return
        hw = first[0].shape[:2]
        self._setup_drop_source(seq, w_i, weather, hw)
        cfg = self._pipeline_config(self._render_settings(), hw, fallrate,
                                    tuple(textures.raw.shape[1:]),
                                    len(files))

        idx = self._frame_indices(len(files))
        prog.start("frame", len(idx))
        # Pending (frame index, name, outputs) after existence filtering.
        work = []
        for i in idx:
            name = os.path.splitext(os.path.basename(files[i]))[0]
            out_img = os.path.join(out_dir, "rainy_image", name + ext)
            out_mask = os.path.join(out_dir, "rain_mask", name + ext)
            if os.path.exists(out_img) or os.path.exists(out_mask):
                if s.conflict_strategy == "skip":
                    stats["skipped"] += 1
                    continue
                if s.conflict_strategy != "overwrite":
                    raise FileExistsError(out_img)
            work.append((i, name, out_img, out_mask))

        os.makedirs(os.path.join(out_dir, "rainy_image"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, "rain_mask"), exist_ok=True)
        if s.save_saturation:
            os.makedirs(os.path.join(out_dir, "saturation_mask"),
                        exist_ok=True)
        if s.save_envmap:
            os.makedirs(os.path.join(out_seq, "envmap"), exist_ok=True)

        def load_one(item):
            i, name, oi, om = item
            pair = data_io.load_frame(files[i], dfiles[i], render_scale,
                                      depth_scale)
            if pair is not None and s.env_type == "pano":
                pair = pair + (self._load_pano(files[i]),)
            return (i, name, oi, om, pair)

        batch: List = []
        done = 0
        for item in data_io.prefetch_map(load_one, work):
            if item[4] is None:
                stats["failed"] += 1
                continue
            batch.append(item)
            if len(batch) == s.batch_size:
                self._render_batch(batch, textures, edges, cfg, out_seq,
                                   stats, pool, saves)
                done += len(batch)
                prog.update("frame", max(done - 1, 0))
                if s.verbose:
                    sys.stdout.write("\r" + prog.line() + "   ")
                batch = []
        if batch:
            self._render_batch(batch, textures, edges, cfg, out_seq, stats,
                               pool, saves)
        if s.verbose:
            sys.stdout.write("\r" + prog.line() + "\n")

    # -- drop sources -----------------------------------------------------
    def _setup_drop_source(self, seq, w_i, weather, hw) -> None:
        """The offline drop source: the weather's particle XML."""
        s = self.spec
        self._streaks = xml_io.load_streaks(
            s.particles[seq][w_i], image_wh=(hw[1], hw[0]),
            render_scale=s.settings["render_scale"], dataset=s.dataset)
        self._frame_ids = sorted(self._streaks)
        self._trunc_seen = set()

    def _frame_record(self, frame_idx: int):
        """Host record of one frame: the file's frame at frame_idx modulo
        the number of simulated frames (reference generator.py:321), or
        None when the file has none. Drops over the capacity are counted
        once a frame (batch padding repeats a frame)."""
        if not self._frame_ids:
            return None
        rec = self._streaks.get(
            self._frame_ids[frame_idx % len(self._frame_ids)])
        if rec is not None and frame_idx not in self._trunc_seen:
            self._trunc_seen.add(frame_idx)
            self._truncated_total += max(
                0, len(rec["ip1"]) - self.spec.drop_capacity)
        return rec

    def _drops_for_frames(self, frame_indices):
        """Stacked DropBatch (leading dim len(frame_indices)) on the
        job's device, packed on the host and moved once per field."""
        return pack_drop_batches(
            [self._frame_record(i) for i in frame_indices],
            self.spec.drop_capacity, self.device)

    def _frame_draws(self, drops, edges, frame_indices):
        """(B, N) texture of every drop and, when the settings ask for
        streak noise, (B, N) noise angles (else None): frame i draws its
        texture picks, then its noise, from a generator seeded
        seed * 100003 + i, whatever batch it is in."""
        s = self.spec
        noisy = s.noise_scale * s.noise_std != 0.0
        picks, noise = [], []
        for b, i in enumerate(frame_indices):
            gen = torch.Generator(device=self.device).manual_seed(
                s.seed * 100003 + i)
            one = drops.map(lambda t: t[b])
            picks.append(select_textures(one, edges, gen))
            if noisy:
                noise.append(torch.randn(one.valid.shape, generator=gen,
                                         device=self.device)
                             * s.noise_std * s.noise_scale)
        return torch.stack(picks), torch.stack(noise) if noisy else None

    def _render_batch(self, batch, textures, edges, cfg, out_seq, stats,
                      pool, saves) -> None:
        s = self.spec
        n_real = len(batch)
        # Pad a short final batch to the job's batch size.
        items = batch + [batch[-1]] * (s.batch_size - n_real)
        fidx = [i for (i, *_rest) in items]

        def stacked(k):
            return torch.as_tensor(np.stack([pair[k] for *_, pair in items]),
                                   device=self.device)

        drops = self._drops_for_frames(fidx)
        tex_idx, noise_deg = self._frame_draws(drops, edges, fidx)
        self._batches += 1
        out = render_frames(
            stacked(0), stacked(1), drops, textures, edges, cfg,
            tex_idx=tex_idx, noise_deg=noise_deg,
            pano=stacked(2) if s.env_type == "pano" else None)
        rainy = out.rainy_image.cpu().numpy()
        masks = out.rain_mask.cpu().numpy()
        envs = out.envmap.cpu().numpy() if cfg.save_envmap else None
        sats = (out.saturation_mask.cpu().numpy()
                if cfg.compute_saturation_mask else None)

        # Padded duplicate frames must not count toward overflow.
        overflow = int(out.overflow[:n_real].sum())
        if overflow > 0:
            self._overflow_total += overflow
            print_warning(
                f"{overflow} drop(s) exceeded bucket capacity and were "
                "dropped — raise --drop_capacity.")

        for bi, (i, name, oi, om, _pair) in enumerate(batch):
            ext = os.path.splitext(oi)[1]
            save_mask = (self._save_mask_npy if ext == ".npy"
                         else self._save_mask)
            saves.append(pool.submit(self._save_rainy, oi, rainy[bi]))
            saves.append(pool.submit(save_mask, om, masks[bi]))
            if envs is not None:
                saves.append(pool.submit(
                    self._save_rainy,
                    os.path.join(out_seq, "envmap", name + ext), envs[bi]))
            if sats is not None:
                saves.append(pool.submit(
                    self._save_rainy,
                    os.path.join(os.path.dirname(os.path.dirname(om)),
                                 "saturation_mask", name + ext),
                    np.clip(sats[bi], 0, 1)))
            stats["rendered"] += 1
