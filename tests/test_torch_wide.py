"""Wide frames: the port against raintpu where an axis reaches 3073 px.

raintpu blurs an axis of ``_BLOCKED_BLUR_MIN_DIM`` (3073) or more with
overlapping block slabs instead of one dense band matrix. The full-
resolution envmap of a frame about 2000 px wide or wider has such an
axis (focal 6 mm: 2048 px gives an envmap 3149 wide, 3840 px one 5905
wide), and so does the fog of any frame that wide on the CPU. Tiny
heights keep these cases quick. Both sides compute in float32 (raintpu
with ``jax_default_matmul_precision="highest"``, the conftest's
setting) and differ in the order of float sums: stages within 1e-5,
the render job at test_torch_pipeline's bars.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.ops import blur as jblur
from raintpu.ops import envmap as jenv
from raintpu.ops import rasterize as jrz
from raintpu.physics import simulator as jsim
from raintpu.render import camera as jcam
from raintpu.render import frame as jframe
from raintpu.render import pipeline as jpipe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.ops import blur as tblur
from raintpu_torch.ops import envmap as tenv
from raintpu_torch.ops import rasterize as trz
from raintpu_torch.render import frame as tframe
from raintpu_torch.render import pipeline as tpipe
from test_torch_pipeline import _jobs, _recording
from torch_cpu_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
FOCAL_MM = 6.0


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=1e-6)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("ksize,sigma", [(15, 2.6), (25, 25.0)])
def test_blocked_axis_blur_matches_raintpu(rng, axis, ksize, sigma):
    """The slab path itself, below the threshold too, at a KITTI-like
    shape: both axes, the tail block padded and cropped."""
    x = rng.rand(2, 37, 1242).astype(np.float32)
    k = jblur.cv2_gaussian_kernel(ksize, sigma)
    key = (ksize, float(k[0]), float(k[ksize // 2]))
    close(tblur._blocked_axis_blur(torch.as_tensor(x), key, k, axis),
          jblur._blocked_axis_blur(jnp.asarray(x), key, k, axis))


@pytest.mark.parametrize("hw,env_w", [((8, 2048), 3149), ((4, 3840), 5905)])
def test_wide_envmap_matches_raintpu(rng, hw, env_w):
    geom = jenv.envmap_geometry(*hw, FOCAL_MM)
    assert dataclasses.asdict(tenv.envmap_geometry(*hw, FOCAL_MM)) == \
        dataclasses.asdict(geom)
    assert geom.env_shape == (hw[0], env_w)
    bg = rng.rand(2, *hw, 3).astype(np.float32)
    got = tenv.generate_envmap(torch.as_tensor(bg), geom)
    assert got.shape == (2, hw[0], env_w, 3)
    for b in range(2):
        close(got[b], jenv.generate_envmap(jnp.asarray(bg[b]), geom))


# A known difference inside the reference: raintpu's render job reads
# the envmap's rows through the jitted _central_source_indices, and
# XLA's fused tan and sqrt round differently from eager evaluation. A
# row coordinate on a rounding tie (within 1e-4 of a half-integer in
# float64) then lands one row off: 2 / 14 / 38 entries of the central
# cylinder at these sizes with the jax installed when this was written.
# The port computes the map eagerly on the CPU, as raintpu's eager map.
@pytest.mark.parametrize("hw", [(375, 1242), (900, 1600), (1016, 2040)])
def test_envmap_index_map_is_raintpus_eager_map(hw):
    geom = jenv.envmap_geometry(*hw, FOCAL_MM)
    got = tenv._host_source_indices(tenv.envmap_geometry(*hw, FOCAL_MM),
                                    torch.float32)
    for g, want in zip(got, jenv._source_indices(geom)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))

    jit_rows = np.asarray(jax.jit(jenv._central_source_indices,
                                  static_argnums=0)(geom)[0])
    b, wc = geom.border, geom.cyl_width
    rows = got[0].numpy()[:, b:b + wc]
    r, c = np.nonzero(rows != jit_rows)
    np.testing.assert_array_equal(np.abs(rows - jit_rows)[r, c], 1)
    h, w = hw
    f = float(geom.focal_env)
    dc = f * np.tan((c + geom.min_x - w // 2) / f)
    coord = (r - h // 2) * np.sqrt(dc ** 2 + f * f) / f + h // 2
    assert np.all(np.abs(coord - np.floor(coord) - 0.5) < 1e-4), coord


def test_wide_batched_fog_matches_raintpu(rng):
    """The fog stage of a (2, 16, 3100) batch: its 25-tap blur runs the
    slab path on W on both sides."""
    h, w = 16, 3100
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)))
    kw = dict(settings=settings, image_hw=(h, w), fallrate=25.0)
    jcfg = jframe.PipelineConfig(raster=jrz.RasterConfig.default(64), **kw)
    tcfg = tframe.PipelineConfig(raster=trz.RasterConfig.default(64), **kw)
    bg = rng.rand(2, h, w, 3).astype(np.float32)
    depth = (rng.rand(2, h, w) * 60 + 3).astype(np.float32)
    close(tframe.batched_fog(torch.as_tensor(bg), torch.as_tensor(depth),
                             tcfg),
          jframe.batched_fog(jnp.asarray(bg), jnp.asarray(depth), jcfg))


H, W, N_FRAMES, CAP = 48, 2048, 2, 64
SETTINGS = {
    "cam_hz": 10, "cam_CCD_WH": [W, H], "cam_CCD_pixsize": 20.0,
    "cam_WH": [W, H], "cam_focal": FOCAL_MM, "cam_gain": 20,
    "cam_f_number": 6.0, "cam_focus_plane": 6.0, "cam_exposure": 2,
    "cam_pos": [1.5, 1.5, 0.3], "cam_lookat": [1.5, 1.5, -1.0],
    "cam_up": [0.0, 1.0, 0.0], "depth_scale": 1, "render_scale": 1,
    "sim_mode": "normal", "sim_duration": 0.5, "sim_steps": {},
    "sim_hz": 2000, "sequences": {},
}


def _wide_dataset(root):
    rng = np.random.RandomState(4)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(root, "seqA", sub))
    for i in range(N_FRAMES):
        np.save(os.path.join(root, "seqA", "rgb", f"{i:06d}.npy"),
                (rng.rand(H, W, 3) * 255).astype(np.uint8))
        np.save(os.path.join(root, "seqA", "depth", f"{i:06d}.npy"),
                (rng.rand(H, W) * 60 + 3).astype(np.float32))
    settings = jcam.settings_from_dict(SETTINGS)
    cfg = jsim.SimConfig.from_settings(settings, capacity=CAP)
    cfg = jsim.SimConfig(**{**cfg.__dict__, "z_max": 3.0})
    return {i: interop.numpy_fields(jsim.simulate_frame(
        jax.random.PRNGKey(200 + i), cfg, 25.0, 5.0))
        for i in range(N_FRAMES)}


def _wide_spec(mod, tmp, out):
    kw = dict(
        dataset="toy", sequences=["seqA"],
        images={"seqA": os.path.join(tmp, "seqA", "rgb")},
        depth={"seqA": os.path.join(tmp, "seqA", "depth")},
        calib={"seqA": None}, particles={"seqA": [None]},
        weather=[{"weather": "rain", "fallrate": 25}], settings=SETTINGS,
        output_root=os.path.join(tmp, out), conflict_strategy="overwrite",
        batch_size=2, drop_capacity=CAP, seed=3, save_format="npy",
        save_saturation=True, save_envmap=True, verbose=False)
    if mod is tpipe:
        kw["device"] = "cpu"
    return mod.JobSpec(**kw)


def test_wide_job_matches_raintpu(tmp_path, monkeypatch):
    """Two 48x2048 frames through both render jobs with the envmap saved
    (48 x 3149: the feather's W axis takes the slab path), on the same
    drops and texture picks, at test_torch_pipeline's bars."""
    tmp = str(tmp_path)
    drops = _wide_dataset(tmp)
    j_out, t_out = [], []
    _recording(monkeypatch, jpipe, j_out)
    _recording(monkeypatch, tpipe, t_out)
    JaxJob, PortJob = _jobs(drops)
    want = JaxJob(_wide_spec(jpipe, tmp, "jax")).run()
    got = PortJob(_wide_spec(tpipe, tmp, "port")).run()
    for key in ("rendered", "skipped", "overflowed_drops"):
        assert got[key] == want[key], key
    assert got["rendered"] == N_FRAMES
    assert len(j_out) == len(t_out) == 1
    j, t = j_out[0], t_out[0]
    assert t["envmap"].shape == (N_FRAMES, H, 3149, 3)
    np.testing.assert_allclose(t["rain_mask"], j["rain_mask"], atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(t["saturation_mask"], j["saturation_mask"],
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(t["envmap"], j["envmap"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t["overflow"], j["overflow"])
    assert float(t["rain_mask"].sum()) > 1.0, "the frames must render rain"
    env_dir = os.path.join(tmp, "port", "toy", "seqA", "envmap")
    assert sorted(os.listdir(env_dir)) == [f"{i:06d}.npy"
                                           for i in range(N_FRAMES)]
