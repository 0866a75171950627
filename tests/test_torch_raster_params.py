"""Per-drop prep of the fused kernel: the port against raintpu.

The same frames, DropBatch, texture bank and texture picks go through
``raintpu.render.frame.drop_fused_params`` (vmapped over frames, after
``frame_background``) and through the port's. Per rung, on valid slots:
params, ayc and bxc agree to atol 1e-5 with rtol 1e-5 (float32 on both
sides; the modal re-analysis sums 64 quadrature points in another
order); bucket routing, slot order, validity and overflow are exact.
Anchors are not compared: the JAX package anchors strip-mode rungs at a
TPU lane-tile basis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raintpu.data.textures import procedural_streak_database, texture_bank
from raintpu.ops import rasterize as jrz
from raintpu.ops.pallas.fused_kernel import P_SGX, P_SGY
from raintpu.physics.simulator import SimConfig, simulate_frames
from raintpu.render import frame as jframe
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu_torch import interop
from raintpu_torch.ops import rasterize as trz
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401

B = 2


def _ladder(cap):
    """bench.py's hand ladder, capacities shrunk to the tiny frames."""
    return ((24, 32, 5, cap, 12, 6, 3), (48, 32, 8, 16, 12, 6, 3),
            (96, 64, 12, 8, 24, 10, 4), (112, 96, 20, 8, 16, 8, 4))


def _configs(w, h, cds, cap):
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)))
    kw = dict(settings=settings, image_hw=(h, w), fallrate=150.0,
              cone_downsample=cds)
    return (jframe.PipelineConfig(raster=jrz.RasterConfig(
                buckets=tuple(jrz.BucketSpec(*b) for b in _ladder(cap))),
                **kw),
            tframe.PipelineConfig(raster=trz.RasterConfig(
                buckets=tuple(trz.BucketSpec(*b) for b in _ladder(cap))),
                **kw))


@pytest.mark.parametrize("w,h,cds", [(192, 96, 4), (96, 48, 1)])
def test_drop_fused_params_match(w, h, cds):
    cap = 32
    jcfg, tcfg = _configs(w, h, cds, cap)
    db = procedural_streak_database()
    bank = texture_bank(db)
    edges = jnp.asarray(db.bin_edges)
    sim = SimConfig(image_wh=(w, h), focal_px=(300.0, 300.0),
                    exposure_s=2e-3, capacity=cap * 2, z_max=5.0)
    drops = simulate_frames(jax.random.PRNGKey(4), sim,
                            jnp.full(B, 150.0), jnp.full(B, 5.0),
                            jnp.full(B, 2e-3), jnp.ones(B))
    rng = np.random.RandomState(1)
    bg = rng.rand(B, h, w, 3).astype(np.float32)
    depth = (rng.rand(B, h, w) * 40 + 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    def stage1(b, d, dr, k):
        _, env_photo, _ = jframe.frame_background(b, d, jcfg)
        return jframe.drop_fused_params(env_photo, dr, bank, edges, k, jcfg)

    j_rungs, j_over = jax.jit(jax.vmap(stage1))(
        jnp.asarray(bg), jnp.asarray(depth), drops, keys)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)

    _, env_t, _ = tframe.frame_background(torch.as_tensor(bg),
                                          torch.as_tensor(depth), tcfg)
    t_rungs, t_over = tframe.drop_fused_params(
        env_t, interop.drop_batch_from_numpy(
            interop.numpy_fields(drops), device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                       device="cpu"),
        torch.as_tensor(db.bin_edges), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)))

    np.testing.assert_array_equal(t_over.numpy(), np.asarray(j_over))
    n_modal = 0
    for i, (jr, tr) in enumerate(zip(j_rungs, t_rungs)):
        valid = np.asarray(jr["valid"])
        np.testing.assert_array_equal(tr.valid.numpy(), valid)
        np.testing.assert_array_equal(tr.drop_idx.numpy(),
                                      np.asarray(jr["drop_idx"]))
        np.testing.assert_array_equal(tr.overflow.numpy(),
                                      np.asarray(jr["overflow"]))
        jp = np.moveaxis(np.asarray(jr["params"]), 1, -1)[valid]
        tp = np.moveaxis(tr.params.numpy(), 1, -1)[valid]
        np.testing.assert_allclose(tp, jp, atol=1e-5, rtol=1e-5,
                                   err_msg=f"rung {i} params")
        for name in ("ayc", "bxc"):
            np.testing.assert_allclose(
                getattr(tr, name).numpy()[valid],
                np.asarray(jr[name])[valid], atol=1e-5, rtol=1e-5,
                err_msg=f"rung {i} {name}")
        # Both anchors clip minC - shift to the image in y.
        np.testing.assert_array_equal(tr.anchor.numpy()[valid][:, 1],
                                      np.asarray(jr["anchor"])[valid][:, 1])
        n_modal += int(((tp[:, P_SGX] == np.float32(2e-3))
                        | (tp[:, P_SGY] == np.float32(2e-3))).sum())
    assert sum(int(r.valid.sum()) for r in t_rungs) > 8
    assert n_modal > 0, "the scene must exercise the modal-blur branch"
