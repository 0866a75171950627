"""The PyTorch port imports and renders with jax and the JAX package
(``raintpu``, not ``raintpu_torch``) made unimportable."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    def blocked(name):
        return (name in ("jax", "raintpu")
                or name.startswith(("jax.", "jaxlib", "raintpu.")))

    class RefuseJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{name} is blocked in this process")
            return None

    sys.meta_path.insert(0, RefuseJax())

    import numpy as np
    import torch
    import raintpu_torch

    names = [m.name for m in pkgutil.walk_packages(
        raintpu_torch.__path__, "raintpu_torch.")]
    for name in names:
        importlib.import_module(name)
    for name in ("raintpu_torch.cli", "raintpu_torch.render.pipeline",
                 "raintpu_torch.render.online",
                 "raintpu_torch.ops.blur_kernel",
                 "raintpu_torch.particles.xml_io",
                 "raintpu_torch.particles.native",
                 "raintpu_torch.tools.particles_simulation",
                 "raintpu_torch.data.datasets.cityscapes",
                 "raintpu_torch.data.nuscenes_data",
                 "raintpu_torch.data.datasets.nuscenes",
                 "raintpu_torch.data.datasets.nuscenes_gan",
                 "raintpu_torch.render.geometry",
                 "raintpu_torch.tools.nuscenes_depth",
                 "raintpu_torch.tools.smooth_depth",
                 "raintpu_torch.tools.check_difference",
                 "raintpu_torch.tools.stage_profile",
                 "raintpu_torch.parallel.mesh",
                 "raintpu_torch.parallel.distributed",
                 "raintpu_torch.main_threaded"):
        assert name in names, name

    from raintpu_torch.data.textures import (procedural_streak_database,
                                             texture_bank)
    from raintpu_torch.ops.rasterize import BucketSpec, RasterConfig
    from raintpu_torch.physics.simulator import SimConfig, simulate_frames
    from raintpu_torch.render.camera import CameraSettings, RenderSettings
    from raintpu_torch.render.frame import (PipelineConfig, render_frame,
                                            render_frames)
    from raintpu_torch.render.frame import drop_fields, drop_patches  # noqa
    from raintpu_torch.ops.blur import variable_separable_blur  # noqa
    from raintpu_torch.ops.composite import composite_drops  # noqa
    from raintpu_torch.ops.rasterize import (RasterBucket,  # noqa
                                             rasterize_frame_drops)

    W, H, B = 64, 32, 2
    gen = torch.Generator().manual_seed(0)
    sim = SimConfig(image_wh=(W, H), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=32, z_max=5.0)
    ones = torch.ones(B)
    drops = simulate_frames(gen, sim, ones * 150.0, ones * 5.0,
                            ones * 2e-3, ones)
    db = procedural_streak_database()
    cfg = PipelineConfig(
        settings=RenderSettings(camera=CameraSettings(wh=(W, H),
                                                      ccd_wh=(W, H))),
        image_hw=(H, W), fallrate=150.0, env_downsample=8,
        raster=RasterConfig(buckets=(BucketSpec(32, 24, 4, 32),)))
    rng = np.random.RandomState(0)
    f32 = torch.float32
    out = render_frames(torch.as_tensor(rng.rand(B, H, W, 3), dtype=f32),
                        torch.as_tensor(rng.rand(B, H, W) * 40 + 3,
                                        dtype=f32),
                        drops, texture_bank(db, device="cpu"),
                        torch.as_tensor(db.bin_edges), cfg, generator=gen)
    assert bool(torch.isfinite(out.rainy_image).all())
    assert tuple(out.rain_mask.shape) == (B, H, W)
    # The golden path: render_frames under "xla", and render_frame.
    import dataclasses
    xla = dataclasses.replace(cfg, composite_mode="xla")
    golden = render_frames(torch.as_tensor(rng.rand(B, H, W, 3), dtype=f32),
                           torch.as_tensor(rng.rand(B, H, W) * 40 + 3,
                                           dtype=f32),
                           drops, texture_bank(db, device="cpu"),
                           torch.as_tensor(db.bin_edges), xla, generator=gen)
    one = render_frame(torch.as_tensor(rng.rand(H, W, 3), dtype=f32),
                       torch.as_tensor(rng.rand(H, W) * 40 + 3, dtype=f32),
                       drops.map(lambda t: t[0]),
                       texture_bank(db, device="cpu").raw,
                       torch.as_tensor(db.bin_edges), cfg, generator=gen)
    assert tuple(golden.rain_mask.shape) == (B, H, W)
    assert tuple(one.rainy_image.shape) == (H, W, 3)
    assert bool(torch.isfinite(one.rainy_image).all())
    loaded = [m for m in sys.modules if blocked(m)]
    assert not loaded, f"the port imported {loaded}"
    print("modules", len(names), "mask", float(out.rain_mask.sum()))
""")


def test_port_imports_and_renders_without_jax():
    # One PyTorch thread, as the in-process tests run (tests/
    # torch_cpu_threads.py): the other test workers share the cores.
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[1])
    assert n_modules >= 20, proc.stdout
