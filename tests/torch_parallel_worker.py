"""One rank of the port's multi-process tests (gloo; nccl is not used).

    python tests/torch_parallel_worker.py HOST:PORT RANK WORLD JOB IN OUT

Imports neither jax nor the JAX package. ``render`` (4 ranks) reads
tests/test_sharding.py's scene from the .npz IN (:func:`save_scene`)
and renders it on a dp 2 x sp 2 mesh (with and without the saturation
planes), on a dp 4 x sp 1 mesh, and on a mesh over the first 2 ranks
only; ``helpers`` (2 ranks) splits a work list, assembles a global tensor
and renders the scene through the golden path (composite_mode "xla",
the saturation planes on) on a dp 1 x sp 2 mesh; ``card`` (2 ranks on
one CUDA card, gloo) renders the scene on a dp 1 x sp 2 mesh and on a
dp 2 x sp 1 mesh. Each rank writes what it saw to OUT (an .npz).
"""

import sys

import numpy as np
import torch

torch.set_num_threads(1)

from raintpu_torch import interop  # noqa: E402
from raintpu_torch.ops.rasterize import BucketSpec, RasterConfig  # noqa: E402
from raintpu_torch.parallel import distributed  # noqa: E402
from raintpu_torch.parallel.mesh import (make_mesh,  # noqa: E402
                                         render_frames_sharded)
from raintpu_torch.render.camera import (CameraSettings,  # noqa: E402
                                         RenderSettings)
from raintpu_torch.render.frame import PipelineConfig  # noqa: E402


def port_config(h, w, cap, sat=False, composite_mode="auto"):
    """tests/test_sharding.py's scene configuration, in the port."""
    settings = RenderSettings(camera=CameraSettings(wh=(w, h),
                                                    ccd_wh=(w, h)))
    raster = RasterConfig(buckets=(BucketSpec(16, 16, 2, cap),
                                   BucketSpec(32, 24, 4, 8)),
                          supersample=1)
    return PipelineConfig(settings=settings, image_hw=(h, w),
                          fallrate=200.0, raster=raster, env_downsample=8,
                          compute_saturation_mask=sat,
                          composite_mode=composite_mode)


def save_scene(path, bg, depth, drop_fields, bank, edges, tex_idx, cap):
    """Write a scene as numpy arrays: frames, depth, the DropBatch's
    fields, the texture bank's raw/ay/bx, bin edges, texture picks and
    the first rung's capacity."""
    np.savez(path, bg=bg, depth=depth, raw=bank[0], ay=bank[1], bx=bank[2],
             edges=edges, tex_idx=tex_idx, cap=cap,
             **{f"drop_{k}": v for k, v in drop_fields.items()})


def scene(path, device="cpu"):
    """(bg, depth, drops, bank, edges, tex_idx, cap) of the .npz, on
    ``device``."""
    z = np.load(path)
    drops = interop.drop_batch_from_numpy(
        {k[5:]: z[k] for k in z.files if k.startswith("drop_")},
        device=device)
    bank = interop.texture_bank_from_numpy(z["raw"], z["ay"], z["bx"],
                                           device=device)
    return tuple(torch.as_tensor(z[k], device=device)
                 for k in ("bg", "depth")) + (
        drops, bank, torch.as_tensor(z["edges"], device=device),
        torch.as_tensor(z["tex_idx"], device=device), int(z["cap"]))


def outputs(prefix, out):
    got = {f"{prefix}_mask": out.rain_mask.numpy(),
           f"{prefix}_image": out.rainy_image.numpy(),
           f"{prefix}_overflow": out.overflow.numpy()}
    if out.saturation_mask is not None:
        got[f"{prefix}_sat"] = out.saturation_mask.numpy()
    return got


def render_job(rank, in_path):
    bg, depth, drops, bank, edges, tex_idx, cap = scene(in_path)
    b, h, w = depth.shape
    got = {}

    def render(mesh, prefix, frames, sat=False):
        f = slice(*frames)
        got.update(outputs(prefix, render_frames_sharded(
            mesh, bg[f], depth[f], drops.map(lambda t: t[f]), bank, edges,
            port_config(h, w, cap, sat), tex_idx=tex_idx[f])))

    # dp 2 x sp 2: dp row d renders frames [2d, 2d + 2).
    mesh = make_mesh(sp=2, device_type="cpu")
    got["layout_22"] = mesh.mesh.numpy()
    dp = mesh.get_local_rank("dp")
    per = b // mesh.size(0)
    got["frames_22"] = np.array([dp * per, dp * per + per])
    render(mesh, "sp2", got["frames_22"])
    render(mesh, "sp2sat", got["frames_22"], sat=True)
    # dp 4 x sp 1: rank r renders frame r, its drops all its own.
    mesh = make_mesh(sp=1, device_type="cpu")
    got["layout_41"] = mesh.mesh.numpy()
    render(mesh, "sp1", (rank, rank + 1))
    # The first two ranks only, dp 1 x sp 2 over every frame; ranks 2-3
    # take part in creating the groups and get None.
    mesh = make_mesh(n_devices=2, sp=2, device_type="cpu")
    got["in_half"] = np.array(mesh is not None)
    if mesh is not None:
        got["layout_half"] = mesh.mesh.numpy()
        render(mesh, "half", (0, b))
    got["bounds_10"] = np.array(distributed.local_batch_bounds(10))
    return got


def helpers_job(rank, in_path):
    from torch.distributed.tensor import Replicate, Shard

    got = {"bounds_10": np.array(distributed.local_batch_bounds(10))}
    mesh = make_mesh(sp=1, device_type="cpu")
    full = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    glob = distributed.make_global_array(
        full[rank * 2:(rank + 1) * 2], mesh, [Shard(0), Replicate()])
    got["global_shape"] = np.array(glob.shape)
    got["global_full"] = glob.full_tensor().numpy()
    bg, depth, drops, bank, edges, tex_idx, cap = scene(in_path)
    b, h, w = depth.shape
    got.update(outputs("xla", render_frames_sharded(
        make_mesh(sp=2, device_type="cpu"), bg, depth, drops, bank, edges,
        port_config(h, w, cap, sat=True, composite_mode="xla"),
        tex_idx=tex_idx)))
    return got


def card_job(rank, in_path):
    bg, depth, drops, bank, edges, tex_idx, cap = scene(in_path, "cuda")
    b, h, w = depth.shape
    got = {}
    # dp 1 x sp 2 over every frame, then dp 2 x sp 1: rank r renders
    # frames [r * b / 2, (r + 1) * b / 2).
    for prefix, sp, f in (("", 2, slice(0, b)),
                          ("dp2_", 1, slice(rank * b // 2,
                                            (rank + 1) * b // 2))):
        out = render_frames_sharded(
            make_mesh(sp=sp), bg[f], depth[f], drops.map(lambda t: t[f]),
            bank, edges, port_config(h, w, cap), tex_idx=tex_idx[f])
        got.update({prefix + k: v.cpu().numpy() for k, v in (
            ("mask", out.rain_mask), ("image", out.rainy_image),
            ("overflow", out.overflow))})
    return got


def main():
    addr, rank, world, job, in_path, out_path = sys.argv[1:7]
    rank, world = int(rank), int(world)
    if job == "card":
        distributed.initialize(addr, world, rank, device="cuda",
                               backend="gloo")
    else:
        distributed.initialize(addr, world, rank, device="cpu")
    try:
        jobs = {"render": lambda: render_job(rank, in_path),
                "helpers": lambda: helpers_job(rank, in_path),
                "card": lambda: card_job(rank, in_path)}
        np.savez(out_path, **jobs[job]())
    finally:
        torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}")


if __name__ == "__main__":
    main()
