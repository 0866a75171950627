"""Device-mesh rendering: frames over dp, each frame's drops over sp.

Counterpart of ``raintpu.parallel.mesh`` on ``torch.distributed``, SPMD
with one process per rank. The ranks form a (dp, sp) mesh:

- ``dp`` (data parallel): each dp row renders its own frames; the axis
  never communicates.
- ``sp`` (streak parallel): the ranks of a dp row split every frame's
  drops. Each accumulates its share into field planes — with the fused
  kernel, or under composite_mode "xla" with the golden path's patches
  and scatter — and one all-reduce (SUM) over the row's sp group adds
  the planes, which are order-independent sums over drops, before each
  rank finishes the frames. The fog and the envmaps run on every sp
  rank (replicated, as in the JAX package).

There is no cache of compiled steps: PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from raintpu_torch.particles.schema import DropBatch
from raintpu_torch.render import frame as frame_mod
from raintpu_torch.render.frame import FrameOutput, PipelineConfig
from raintpu_torch.utils import profiling


def make_mesh(n_devices: Optional[int] = None, sp: int = 1,
              device_type: str = "cuda") -> Optional[DeviceMesh]:
    """A (dp, sp) DeviceMesh, dims named ("dp", "sp"), over the first
    ``n_devices`` ranks of the default process group (all of them when
    None): rank = dp_index * sp + sp_index. ``sp`` must divide the rank
    count; dp = n_devices // sp.

    Creating the mesh's groups is collective, so every rank of the
    default group calls this with the same arguments, in the same order
    as its other group creations. A rank outside the first
    ``n_devices`` takes part and gets None.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "raintpu_torch.parallel.distributed.initialize first (one "
            "process: initialize('localhost:<port>', 1, 0))")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"n_devices={n_devices}: the group has {world} "
                         "ranks")
    if n % sp:
        raise ValueError(f"sp={sp} must divide the rank count {n}")
    ranks = torch.arange(n, dtype=torch.int32).reshape(n // sp, sp)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=("dp", "sp"))
    return mesh if dist.get_rank() < n else None


def split_drops_for_sp(drops: DropBatch, sp: int) -> DropBatch:
    """Pad a (B, N, ...) DropBatch's N up to a multiple of sp (the
    padded rows are zeros: invalid drops)."""
    pad = (-drops.valid.shape[1]) % sp
    if pad == 0:
        return drops

    def padn(t):
        return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                         dim=1)

    return drops.map(padn)


def render_frames_sharded(mesh: DeviceMesh,
                          bg: torch.Tensor,
                          depth: torch.Tensor,
                          drops: DropBatch,
                          textures,
                          bin_edges: torch.Tensor,
                          cfg: PipelineConfig,
                          generator: Optional[torch.Generator] = None,
                          tex_idx: Optional[torch.Tensor] = None,
                          noise_deg: Optional[torch.Tensor] = None
                          ) -> FrameOutput:
    """Render this dp row's frames with their drops split over sp.

    bg (B, H, W, 3), depth (B, H, W) and drops (B, N, ...) are this
    rank's dp row's frames, each with all its N drops (N divisible by
    the sp size: :func:`split_drops_for_sp`). The random draws
    (:func:`raintpu_torch.render.frame.frame_draws`: texture picks,
    then streak noise) are made over the whole (B, N) before each rank
    keeps its sp slice of drops, picks and noise, so the render does not
    depend on the sp layout. Every sp rank of a dp row must therefore
    pass an equally seeded ``generator``, or the same ``tex_idx`` /
    ``noise_deg`` (B, N). Each rank accumulates its slice's fields as
    cfg.resolved_composite_mode() says (the fused kernel, or under "xla"
    :func:`raintpu_torch.render.frame.drop_fields`), the field planes
    and the overflow counts are summed over the sp group (one
    all-reduce each; no collective when it has one rank), and the rank
    returns its dp row's ``FrameOutput``, the same on every sp rank of
    the row.
    ``cfg.save_envmap`` and ``cfg.compute_saturation_mask`` add their
    outputs; the pano envmap is not taken (nor by the JAX package's
    sharded render). A call is a render step of the stage spans
    (``utils.profiling``), as ``render_frames`` is.
    """
    profiling.next_step()
    sp = mesh.size(1)
    n = drops.valid.shape[1]
    if n % sp:
        raise ValueError(f"{n} drops a frame do not split over sp={sp}: "
                         "pad them with split_drops_for_sp")
    tex_idx, noise_deg = frame_mod.frame_draws(drops, bin_edges, cfg,
                                               generator, tex_idx,
                                               noise_deg)
    n_local = n // sp
    start = mesh.get_local_rank("sp") * n_local
    mine = slice(start, start + n_local)
    draws = dict(tex_idx=tex_idx[:, mine],
                 noise_deg=None if noise_deg is None else noise_deg[:, mine])
    drops = drops.map(lambda t: t[:, mine])
    if cfg.resolved_composite_mode() == "xla":
        fogged, env_photo, env_save = frame_mod.frame_background(bg, depth,
                                                                 cfg)
        fields, overflow = frame_mod.drop_fields(env_photo, drops, textures,
                                                 bin_edges, cfg, **draws)
        planes = fields.planes()
    else:
        fogged, env_save, planes, overflow = frame_mod.fused_field_planes(
            bg, depth, drops, textures, bin_edges, cfg, **draws)
    if sp > 1:
        group = mesh.get_group("sp")
        dist.all_reduce(planes, op=dist.ReduceOp.SUM, group=group)
        dist.all_reduce(overflow, op=dist.ReduceOp.SUM, group=group)
    return frame_mod.finalize_frame(
        bg, fogged, frame_mod.crop_field_planes(planes, cfg), env_save,
        overflow, cfg)
