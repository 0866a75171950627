"""The port's multi-process rendering (``raintpu_torch.parallel``) against
raintpu's, on the CPU with gloo.

The port runs as real processes (tests/torch_parallel_worker.py, one
per rank, one PyTorch thread each) on tests/test_sharding.py's scene:
B = 4 frames of 32x64, 16 drops a frame. raintpu renders the same
inputs on the conftest's 8-device CPU mesh (``make_mesh(sp=2)``: dp 4 x
sp 2, the fused path in interpret mode), and its texture picks — keyed
by global drop index, so the same for any sp layout — are passed to the
port as data. Rain mask and image agree within atol 2e-4 (the fused
path's own bar against the XLA path, tests/test_pallas_batched.py), the
overflow counts are equal. Within the port, sp 2 and sp 1 differ only
in the order of the planes' float sums: atol 1e-5, alpha mass within a
relative 1e-5 (tests/test_sharding.py's bars); a one-rank group renders
exactly what render_frames renders. The golden path's sharded branch
(composite_mode "xla", on 2 ranks) holds to the golden path on one
process within 1e-6 — the same patches, each rank's half of a frame's
drops scattered on its own and the planes then added.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from raintpu.data.textures import procedural_streak_database, texture_bank
from raintpu.ops import rasterize as jrz
from raintpu.parallel import mesh as jmesh
from raintpu.particles.schema import DropBatch as JaxDropBatch
from raintpu.physics.simulator import SimConfig, simulate_frames
from raintpu.render.camera import CameraSettings, RenderSettings
from raintpu.render.frame import PipelineConfig
from raintpu_torch import interop
from raintpu_torch.parallel import distributed
from raintpu_torch.parallel import mesh as tmesh
from raintpu_torch.render import frame as tframe
from torch_cpu_threads import one_torch_thread  # noqa: F401
from torch_parallel_worker import port_config, save_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
B, H, W, CAP = 4, 32, 64, 16
ATOL = 2e-4
LAYOUT_ATOL = 1e-5
MASS_RTOL = 1e-5
XLA_SP_ATOL = 1e-6
TIMEOUT_S = 240


def _jax_scene():
    """tests/test_sharding.py's _setup(B=4), the fused path."""
    settings = RenderSettings(camera=CameraSettings(
        wh=(W, H), ccd_wh=(W, H)))
    sim_cfg = SimConfig(image_wh=(W, H), focal_px=(400.0, 400.0),
                        exposure_s=2e-3, capacity=CAP, z_max=4.0)
    drops = simulate_frames(jax.random.PRNGKey(0), sim_cfg,
                            jnp.full(B, 200.0), jnp.full(B, 5.0),
                            jnp.full(B, 2e-3), jnp.ones(B))
    rng = np.random.RandomState(0)
    bg = rng.rand(B, H, W, 3).astype(np.float32)
    depth = (rng.rand(B, H, W) * 50 + 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    raster = jrz.RasterConfig(buckets=(jrz.BucketSpec(16, 16, 2, CAP),
                                       jrz.BucketSpec(32, 24, 4, 8)),
                              supersample=1)
    cfg = PipelineConfig(settings=settings, image_hw=(H, W),
                         fallrate=200.0, raster=raster, env_downsample=8,
                         composite_mode="fused")
    return bg, depth, drops, keys, cfg


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, job, in_path, out_dir):
    addr = f"localhost:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, WORKER, addr, str(r), str(world), job,
         str(in_path), str(out_dir / f"{job}{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(world)]


def _collect(procs, out_dir, job):
    """Wait for every rank (killing all on a time-out); each must exit 0.
    Returns every rank's .npz as a dict."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RANK_OK {r}" in log, log
    return [dict(np.load(out_dir / f"{job}{r}.npz"))
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4-rank and 2-rank jobs, and raintpu's sharded render
    (with the saturation planes) meanwhile."""
    tmp = tmp_path_factory.mktemp("parallel")
    bg, depth, drops, keys, cfg = _jax_scene()
    db = procedural_streak_database()
    bank = texture_bank(db)
    edges = jnp.asarray(db.bin_edges)
    drops = jmesh.split_drops_for_sp(drops, 2)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)
    fields = interop.numpy_fields(drops)
    save_scene(tmp / "scene.npz", bg, depth, fields,
               (bank.raw, bank.ay, bank.bx), db.bin_edges,
               np.asarray(tex_idx), CAP)
    render = _spawn(4, "render", tmp / "scene.npz", tmp)
    helpers = _spawn(2, "helpers", tmp / "scene.npz", tmp)
    try:
        out = jmesh.render_frames_sharded(
            jmesh.make_mesh(sp=2), jnp.asarray(bg), jnp.asarray(depth),
            drops, bank, edges, keys,
            dataclasses.replace(cfg, compute_saturation_mask=True))
        want = {k: None if v is None else np.asarray(v)
                for k, v in dataclasses.asdict(out).items()}
    finally:
        got = _collect(render, tmp, "render")
        aux = _collect(helpers, tmp, "helpers")
    return dict(want=want, got=got, aux=aux, inputs=(bg, depth, fields),
                tex_idx=np.asarray(tex_idx), db=db)


def _gather(got, prefix, ranks):
    """The frames of ``ranks`` (one per dp row), concatenated."""
    return {k: np.concatenate([got[r][f"{prefix}_{k}"] for r in ranks])
            for k in ("mask", "image", "overflow", "sat")
            if f"{prefix}_{k}" in got[ranks[0]]}


@pytest.mark.parametrize("sat", [False, True],
                         ids=["plain", "saturation"])
def test_sharded_matches_raintpu(runs, sat):
    """dp 2 x sp 2 on 4 gloo ranks, with and without the saturation
    planes, against raintpu's dp 4 x sp 2 with them (its mask and image
    are separate sums of the same kernel, whether or not it adds the
    saturation planes; raintpu is run once to keep tier-1 short)."""
    prefix = "sp2sat" if sat else "sp2"
    got = _gather(runs["got"], prefix, [0, 2])
    want = runs["want"]
    assert got["mask"].shape == (B, H, W) and got["mask"].sum() > 1.0
    np.testing.assert_allclose(got["mask"], want["rain_mask"], atol=ATOL)
    np.testing.assert_allclose(got["image"], want["rainy_image"],
                               atol=ATOL)
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    if sat:
        assert want["saturation_mask"].sum() > 0
        np.testing.assert_allclose(got["sat"], want["saturation_mask"],
                                   atol=ATOL)
    else:
        assert "sat" not in got
    # Both sp ranks of a dp row return the row's frames.
    for a, b in ((0, 1), (2, 3)):
        mine, other = (_gather(runs["got"], prefix, [r]) for r in (a, b))
        for k in mine:
            np.testing.assert_array_equal(other[k], mine[k])


def test_sp_layout_invariant(runs):
    """sp 2 against sp 1 (every drop on its frame's own rank)."""
    sp2 = _gather(runs["got"], "sp2", [0, 2])
    sp1 = _gather(runs["got"], "sp1", [0, 1, 2, 3])
    half = _gather(runs["got"], "half", [0])
    for other in (sp2, half):
        np.testing.assert_allclose(other["mask"], sp1["mask"],
                                   atol=LAYOUT_ATOL)
        np.testing.assert_allclose(other["image"], sp1["image"],
                                   atol=LAYOUT_ATOL)
        np.testing.assert_array_equal(other["overflow"], sp1["overflow"])
        a1, a2 = float(sp1["mask"].sum()), float(other["mask"].sum())
        assert a2 > 0 and abs(a1 - a2) / a1 < MASS_RTOL


def test_sharded_xla_branch(runs):
    """dp 1 x sp 2 through the golden path on 2 gloo ranks (the
    saturation planes on) against render_frames' golden path in this
    process within 1e-6, the same on both ranks, and within the fused
    path's bar of raintpu's sharded render."""
    bg, depth, fields = runs["inputs"]
    db = runs["db"]
    jbank = texture_bank(db)
    cfg = port_config(H, W, CAP, sat=True, composite_mode="xla")
    want = tframe.render_frames(
        torch.as_tensor(bg), torch.as_tensor(depth),
        interop.drop_batch_from_numpy(fields, device="cpu"),
        interop.texture_bank_from_numpy(jbank.raw, jbank.ay, jbank.bx,
                                        device="cpu"),
        torch.as_tensor(db.bin_edges), cfg,
        tex_idx=torch.from_numpy(runs["tex_idx"].copy()))
    got = [_gather(runs["aux"], "xla", [r]) for r in (0, 1)]
    assert got[0]["mask"].shape == (B, H, W) and got[0]["mask"].sum() > 1.0
    for k in got[0]:
        np.testing.assert_array_equal(got[1][k], got[0][k])
    for k, name in (("mask", "rain_mask"), ("image", "rainy_image"),
                    ("sat", "saturation_mask")):
        np.testing.assert_allclose(got[0][k], getattr(want, name).numpy(),
                                   atol=XLA_SP_ATOL, err_msg=k)
        np.testing.assert_allclose(got[0][k], runs["want"][name], atol=ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got[0]["overflow"], want.overflow.numpy())
    np.testing.assert_array_equal(got[0]["overflow"],
                                  runs["want"]["overflow"])


def test_mesh_rank_layout(runs):
    """rank = dp_index * sp + sp_index, as np.reshape(dp, sp) lays the
    JAX package's devices out; ranks outside n_devices get None."""
    for r, got in enumerate(runs["got"]):
        np.testing.assert_array_equal(got["layout_22"],
                                      np.arange(4).reshape(2, 2))
        np.testing.assert_array_equal(got["layout_41"],
                                      np.arange(4).reshape(4, 1))
        np.testing.assert_array_equal(got["frames_22"],
                                      [2 * (r // 2), 2 * (r // 2) + 2])
        assert bool(got["in_half"]) == (r < 2)
        if r < 2:
            np.testing.assert_array_equal(got["layout_half"], [[0, 1]])


def test_local_batch_bounds(runs):
    """A contiguous, non-overlapping cover of 10 items on 2 and 4
    ranks, and the whole list without a group."""
    assert [tuple(a["bounds_10"]) for a in runs["aux"]] == [(0, 5), (5, 10)]
    assert [tuple(g["bounds_10"]) for g in runs["got"]] == [
        (0, 3), (3, 6), (6, 9), (9, 10)]
    assert distributed.local_batch_bounds(10) == (0, 10)


def test_make_global_array(runs):
    """Two ranks' (2, 3) shards make one (4, 3) global tensor, whose
    gathered value holds both ranks' data."""
    full = np.arange(12, dtype=np.float32).reshape(4, 3)
    for aux in runs["aux"]:
        np.testing.assert_array_equal(aux["global_shape"], [4, 3])
        np.testing.assert_array_equal(aux["global_full"], full)


def test_split_drops_for_sp_matches_raintpu():
    rng = np.random.RandomState(3)
    fields = {
        "ip1": rng.rand(2, 15, 2), "ip2": rng.rand(2, 15, 2),
        "iw1": rng.rand(2, 15), "iw2": rng.rand(2, 15),
        "wp1": rng.rand(2, 15, 3), "wp2": rng.rand(2, 15, 3),
        "max_width": rng.randint(1, 9, (2, 15)),
        "length": rng.randint(1, 30, (2, 15)), "ratio": rng.rand(2, 15),
        "drop_type": rng.randint(0, 3, (2, 15)),
        "valid": rng.rand(2, 15) > 0.3}
    port = interop.drop_batch_from_numpy(fields, device="cpu")
    jax_batch = JaxDropBatch(**{k: jnp.asarray(v) for k, v in
                                interop.numpy_fields(port).items()})
    for sp in (1, 2, 4):
        want = interop.numpy_fields(jmesh.split_drops_for_sp(jax_batch, sp))
        got = interop.numpy_fields(tmesh.split_drops_for_sp(port, sp))
        assert got["valid"].shape == (2, -(-15 // sp) * sp)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_world_size_one_equals_render_frames(runs):
    """A one-rank group's sharded render (sp 1: no collective) gives
    the bits of render_frames, on the scene's frames and texture picks."""
    bg, depth, fields = runs["inputs"]
    db = runs["db"]
    drops = interop.drop_batch_from_numpy(fields, device="cpu")
    jbank = texture_bank(db)
    bank = interop.texture_bank_from_numpy(jbank.raw, jbank.ay, jbank.bx,
                                           device="cpu")
    args = (torch.as_tensor(bg), torch.as_tensor(depth), drops, bank,
            torch.as_tensor(db.bin_edges))
    cfg = port_config(H, W, CAP, sat=True)
    tex_idx = torch.from_numpy(runs["tex_idx"].copy())
    distributed.initialize(f"localhost:{_free_port()}", 1, 0, device="cpu")
    try:
        mesh = tmesh.make_mesh(device_type="cpu")
        got = tmesh.render_frames_sharded(mesh, *args, cfg, tex_idx=tex_idx)
    finally:
        dist.destroy_process_group()
    want = tframe.render_frames(*args, cfg, tex_idx=tex_idx)
    assert want.rain_mask.sum() > 1.0
    for name in ("rainy_image", "rain_mask", "overflow", "saturation_mask"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_initialize_without_a_cluster_warns(monkeypatch, capsys):
    """No coordinator and no launcher variables: env:// fails, and the
    warning names the exception; the run stays single-process."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize(device="cpu")
    assert not dist.is_initialized()
    out = capsys.readouterr().out
    assert "torch.distributed env:// init failed (ValueError" in out, out
    assert "continuing single-process" in out
    assert distributed.local_batch_bounds(10) == (0, 10)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.make_mesh(device_type="cpu")
