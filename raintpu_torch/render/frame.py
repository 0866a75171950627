"""The batched per-frame render pipeline in PyTorch.

Counterpart of ``raintpu.render.frame``: its fused path
(``render_frames`` -> ``_render_frames_fused`` -> ``fused_field_planes``)
and its XLA "golden" path (``render_frame`` -> ``drop_fields`` ->
``drop_patches`` + ``composite_drops``). The fused path runs stage by
stage over a batch of B frames:

    fog attenuation          batched_fog -> ops.fog (the stencil blur
                             kernel, ops.blur_kernel, on a GPU)
    envmap generation        ops.envmap (at photometry resolution, and
                             at full resolution for save_envmap)
    per-drop photometry      ops.photometry
    per-drop prep            ops.rasterize + ops.composite.blend_coefficients
    streak raster+composite  ops.fused_raster (the CUDA kernel on a GPU;
                             5 planes, or 8 with the saturation mask)
    blend + contrast adjust  ops.composite.blend, finalize_frame

The golden path (``composite_mode="xla"``, and :func:`render_frame`
always) shares the fog, envmaps, photometry and per-drop geometry, then
rasterizes every drop into a patch of its rung
(ops.rasterize.rasterize_frame_drops: the DCT series, or with
``texture_mode="gather"`` a bilinear gather of the textures and a
per-drop blur) and scatter-adds the patches into the fields
(ops.composite.composite_drops). It never calls the raster kernel nor
its plain version: it is the independent algorithm the fused kernel is
held to.

Every option of the JAX render goes through these stages: the physics
strategy or the paper's baselines ``white`` and ``naive_db`` (unit
gains, no defocus, no photometry envmap), streak noise (each
Small/Medium drop rotated by its own noise angle, given as data or
drawn from the frame's generator), and the captured-panorama envmap
(``env_type='pano'``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raintpu_torch.ops import composite as composite_ops
from raintpu_torch.ops import envmap as envmap_ops
from raintpu_torch.ops import fog as fog_ops
from raintpu_torch.ops import photometry as photometry_ops
from raintpu_torch.ops import rasterize as raster_ops
from raintpu_torch.ops.fused_raster import (N_PLANES, N_PLANES_SAT,
                                            RasterRung,
                                            fused_raster_composite)
from raintpu_torch.particles.schema import DropBatch
from raintpu_torch.render.camera import RenderSettings


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static per-weather render configuration.

    The fields of the JAX PipelineConfig, less its TPU layout knobs
    (fields_dtype, row_strip, pair_eval, narrow_dma, resident): the
    fused path accumulates float32 planes in one kernel launch.
    """

    settings: RenderSettings
    image_hw: Tuple[int, int]       # (H, W) at render scale
    fallrate: float                 # mm/hr
    raster: raster_ops.RasterConfig
    env_downsample: int = 4
    save_envmap: bool = False
    compute_saturation_mask: bool = False
    # Field accumulation path:
    #   "fused" -> the raster+composite kernel (its plain version on CPU
    #              tensors): ops.fused_raster
    #   "xla"   -> patches first, then a scatter-add (the golden path)
    #   "auto"  -> "fused" on every device. The JAX package resolves
    #              "auto" by backend ("fused" on a TPU, "xla" elsewhere)
    #              because its kernel compiles only for the TPU; the
    #              port's fused path runs on the CPU too.
    composite_mode: str = "auto"
    # Extra block-reduction of the envmap features used only for the
    # per-drop cone photometry (on top of env_downsample); 1 = exact.
    cone_downsample: int = 1
    # Fold cone_downsample into envmap generation: generate the
    # photometry envmap at the cds-effective resolution (see
    # env_downsamples).
    env_fold: bool = True

    def resolved_composite_mode(self) -> str:
        mode = self.composite_mode
        if mode == "auto":
            return "fused"
        if mode not in ("fused", "xla"):
            raise ValueError(
                f"composite_mode={mode!r}: expected 'auto', 'fused' or "
                "'xla' (the two-stage 'pallas' mode was retired)")
        return mode

    @property
    def image_wh(self) -> Tuple[int, int]:
        return (self.image_hw[1], self.image_hw[0])

    @staticmethod
    def build(settings: RenderSettings, image_hw, fallrate,
              drop_capacity: int = 2048, **kw) -> "PipelineConfig":
        return PipelineConfig(
            settings=settings, image_hw=tuple(image_hw),
            fallrate=float(fallrate),
            raster=raster_ops.RasterConfig.default(drop_capacity), **kw)


@dataclasses.dataclass
class FrameOutput:
    """A render's outputs: (B, ...) from render_frames, without the B
    from render_frame."""

    rainy_image: torch.Tensor          # (B, H, W, 3) RGB in [0, 1]
    rain_mask: torch.Tensor            # (B, H, W) accumulated alpha
    envmap: Optional[torch.Tensor]     # (B, H, W_env, 3) or None
    overflow: torch.Tensor             # (B, n_buckets) dropped-drop counts
    # (B, H, W, 3) sum of clipped per-drop colors — the reference's
    # rainy_saturation_mask; None unless cfg.compute_saturation_mask.
    saturation_mask: Optional[torch.Tensor] = None


# env_fold floor: the generated photometry envmap keeps at least this
# many texels per image axis (below it the fold degrades gracefully).
_ENV_FOLD_MIN = 6


def env_downsamples(cfg: PipelineConfig) -> Tuple[int, int]:
    """(envmap-generation downsample, feature downsample).

    With env_fold the cone block-reduction moves into envmap
    generation: the fold factor is the largest divisor of
    cone_downsample that keeps the generated map at >= _ENV_FOLD_MIN
    texels per axis; the features block-reduce by the remaining
    cds/fold.
    """
    ds = max(int(cfg.env_downsample), 1)
    cds = max(int(cfg.cone_downsample), 1)
    if not cfg.env_fold or cds == 1:
        return ds, cds
    h, w = cfg.image_hw
    f = cds
    while f > 1 and (cds % f != 0
                     or min(h, w) // (ds * f) < _ENV_FOLD_MIN):
        f -= 1
    return ds * f, cds // f


def _avg_pool_rgb(img: torch.Tensor, ds: int) -> torch.Tensor:
    """Block-mean pool the (H, W) axes of (..., H, W, C) (trailing
    rows/cols that do not fill a block are dropped)."""
    if ds <= 1:
        return img
    h, w, c = img.shape[-3:]
    hq, wq = (h // ds) * ds, (w // ds) * ds
    x = img[..., :hq, :wq, :].reshape(
        img.shape[:-3] + (h // ds, ds, wq // ds, ds, c))
    return (x * (1.0 / ds)).sum(-4).mean(-2)


def batched_fog(bg: torch.Tensor, depth: torch.Tensor,
                cfg: PipelineConfig) -> torch.Tensor:
    """Whole-batch fog stage: bg (B, H, W, 3), depth (B, H, W) -> the
    fogged frames, its 25-tap blur one launch of the stencil kernel over
    the batch's (4B, H, W) stack on a GPU."""
    cam = cfg.settings.camera
    return fog_ops.fog_rain_layer(
        bg.to(torch.float32), depth.to(torch.float32),
        rain_intensity=cfg.fallrate, f_number=cam.f_number,
        exposure_s=cam.exposure_s, camera_gain=cam.gain)


def frame_background(bg: torch.Tensor, depth: torch.Tensor,
                     cfg: PipelineConfig,
                     pano: Optional[torch.Tensor] = None):
    """Drop-independent stage: fog + the envmaps. bg (B, H, W, 3),
    depth (B, H, W) -> (fogged, env_photo, env_save): env_photo at the
    photometry resolution (None unless the physics strategy reads it),
    env_save the full-resolution envmap when cfg.save_envmap, else None.
    With env_type 'pano' the envmap is ``pano`` (B, He, We, 3), the
    captured panorama, of any size; else it is extrapolated from the
    fogged frames."""
    st = cfg.settings
    cam = st.camera
    h, w = cfg.image_hw
    physics = st.rendering_strategy is None
    fogged = batched_fog(bg, depth, cfg)
    gen_ds, _ = env_downsamples(cfg)
    env_photo = env_save = None
    if st.env_type == "pano" and (physics or cfg.save_envmap):
        if pano is None:
            raise ValueError("env_type='pano' requires a panorama input")
        pano = pano.to(torch.float32)
        if physics:
            env_photo = _avg_pool_rgb(pano, gen_ds)
        if cfg.save_envmap:
            env_save = pano
    elif physics or cfg.save_envmap:
        if physics:
            geom_lo = envmap_ops.envmap_geometry(h // gen_ds, w // gen_ds,
                                                 cam.focal)
            env_photo = envmap_ops.generate_envmap(
                _avg_pool_rgb(fogged, gen_ds), geom_lo)
        if cfg.save_envmap:
            env_save = envmap_ops.generate_envmap(
                fogged, envmap_ops.envmap_geometry(h, w, cam.focal))
    return fogged, env_photo, env_save


def frame_draws(drops: DropBatch, bin_edges: torch.Tensor,
                cfg: PipelineConfig,
                generator: Optional[torch.Generator] = None,
                tex_idx: Optional[torch.Tensor] = None,
                noise_deg: Optional[torch.Tensor] = None):
    """The render's random draws over a (B, N) drop batch: every drop's
    texture pick and, when the settings' noise_scale * noise_std is not
    0, its streak-noise angle in degrees (standard normal times
    noise_std * noise_scale). A draw given as data is kept; the missing
    ones come from ``generator``, the texture picks first. Returns
    (tex_idx (B, N) int64, noise_deg (B, N) float32 or None) on the
    drops' device."""
    st = cfg.settings
    dev = drops.valid.device
    if tex_idx is None:
        tex_idx = raster_ops.select_textures(drops, bin_edges, generator)
    tex_idx = tex_idx.to(device=dev, dtype=torch.int64)
    if noise_deg is None and st.noise_scale * st.noise_std != 0.0:
        noise_deg = (torch.randn(drops.valid.shape, generator=generator,
                                 device=dev)
                     * st.noise_std * st.noise_scale)
    if noise_deg is not None:
        noise_deg = noise_deg.to(device=dev, dtype=torch.float32)
    return tex_idx, noise_deg


def _drop_prep(env_rgb: Optional[torch.Tensor], drops: DropBatch,
               tex_hw, bin_edges: torch.Tensor, cfg: PipelineConfig,
               generator: Optional[torch.Generator],
               tex_idx: Optional[torch.Tensor],
               noise_deg: Optional[torch.Tensor]):
    """The per-drop stage both paths share: photometry gains, the
    draws (:func:`frame_draws`), geometry and blend coefficients.
    Under 'white' and 'naive_db' the gains are ones and nothing is
    defocused (``env_rgb`` is not read). Returns (gains, tex_idx, geom,
    lo, add_rgb)."""
    st = cfg.settings
    cam = st.camera
    physics = st.rendering_strategy is None
    if physics:
        env = photometry_ops.env_features(
            env_rgb, downsample=env_downsamples(cfg)[1])
        mid = (drops.wp1 + drops.wp2) / 2.0
        gains = photometry_ops.drop_colors(
            mid, env, sphere_radius=st.sphere_radius,
            fov_deg=st.drop_fov_deg, irrad_type=st.irrad_type)
    else:
        gains = torch.ones(drops.valid.shape + (3,), dtype=torch.float32,
                           device=drops.valid.device)

    tex_idx, noise_deg = frame_draws(drops, bin_edges, cfg, generator,
                                     tex_idx, noise_deg)
    geom_d = raster_ops.drop_geometry(
        drops, tex_hw, cfg.image_wh,
        focal_m=cam.focal_m, f_number=cam.f_number,
        focus_plane=st.focus_plane, coc_pixsize=cfg.raster.coc_pixsize,
        apply_defocus=physics, noise_deg=noise_deg)
    lo, add_scale = composite_ops.blend_coefficients(
        drops.iw1, drops.iw2, drops.length,
        exposure_s=cam.exposure_s,
        opacity_attenuation=st.opacity_attenuation,
        rendering_strategy=st.rendering_strategy)
    return gains, tex_idx, geom_d, lo, gains * add_scale[..., None]


def drop_fused_params(env_rgb: Optional[torch.Tensor], drops: DropBatch,
                      textures, bin_edges: torch.Tensor, cfg: PipelineConfig,
                      generator: Optional[torch.Generator] = None,
                      tex_idx: Optional[torch.Tensor] = None,
                      noise_deg: Optional[torch.Tensor] = None):
    """Per-frame parameter prep for the fused kernel: photometry gains,
    texture pick, streak noise, geometry, damped DCT coefficients and
    blend rows.

    ``tex_idx`` (B, N): the texture of every drop, given as data; when
    None it is drawn from ``generator``. ``noise_deg`` (B, N): every
    drop's noise angle in degrees, given as data; when None and the
    settings ask for streak noise, it is drawn from ``generator`` after
    the texture picks (:func:`frame_draws`). Under the 'white' and
    'naive_db' strategies the gains are ones and nothing is defocused
    (``env_rgb`` is not read). The saturation rows carry the drops'
    pre-tau colors when cfg.compute_saturation_mask, else 0.
    Returns (list of rasterize.RungParams, overflow (B, n_buckets))."""
    tex_hw = tuple(textures.raw.shape[1:])
    gains, tex_idx, geom_d, lo, add_rgb = _drop_prep(
        env_rgb, drops, tex_hw, bin_edges, cfg, generator, tex_idx,
        noise_deg)
    rungs = raster_ops.raster_params_frame(
        drops, geom_d, tex_hw, tex_idx, cfg.image_wh, cfg.raster,
        apply_defocus=cfg.settings.rendering_strategy is None,
        fourier=(textures.ay, textures.bx))
    sat_rgb = gains if cfg.compute_saturation_mask else None
    for rung in rungs:
        raster_ops.fill_blend_rows(rung, lo, add_rgb, sat_rgb)
    overflow = torch.stack([r.overflow for r in rungs], dim=-1)
    return rungs, overflow


def drop_patches(env_rgb: Optional[torch.Tensor], drops: DropBatch,
                 textures, bin_edges: torch.Tensor, cfg: PipelineConfig,
                 generator: Optional[torch.Generator] = None,
                 tex_idx: Optional[torch.Tensor] = None,
                 noise_deg: Optional[torch.Tensor] = None):
    """The golden path's per-drop stage up to rasterized patches:
    photometry, draws, geometry and rasterization with the defocus
    folded in, for one frame (N, ...) or a batch (B, N, ...).

    ``textures``: a TextureBank (raw textures and DCT factors: the
    series, unless cfg.raster.texture_mode is "gather") or a plain
    (K, TH, TW) tensor (always the gather). Draws and strategies as in
    :func:`drop_fused_params`. Returns (buckets, lo (..., N), add_rgb
    (..., N, 3), gains (..., N, 3), overflow (..., n_buckets)); gains
    is the drops' pre-tau color, the saturation mask's payload."""
    fourier = None
    if hasattr(textures, "ay"):
        fourier = (textures.ay, textures.bx)
        textures = textures.raw
    gains, tex_idx, geom_d, lo, add_rgb = _drop_prep(
        env_rgb, drops, tuple(textures.shape[1:]), bin_edges, cfg,
        generator, tex_idx, noise_deg)
    buckets = raster_ops.rasterize_frame_drops(
        drops, geom_d, textures, tex_idx, cfg.image_wh, cfg.raster,
        apply_defocus=cfg.settings.rendering_strategy is None,
        fourier=fourier)
    overflow = torch.stack([b.overflow for b in buckets], dim=-1)
    return buckets, lo, add_rgb, gains, overflow


def drop_fields(env_rgb: Optional[torch.Tensor], drops: DropBatch,
                textures, bin_edges: torch.Tensor, cfg: PipelineConfig,
                generator: Optional[torch.Generator] = None,
                tex_idx: Optional[torch.Tensor] = None,
                noise_deg: Optional[torch.Tensor] = None):
    """:func:`drop_patches` and the scatter composite: the golden
    path's fields. Returns (composite.FieldMaps (..., H, W), overflow
    (..., n_buckets)); the saturation mask is summed when
    cfg.compute_saturation_mask."""
    buckets, lo, add_rgb, gains, overflow = drop_patches(
        env_rgb, drops, textures, bin_edges, cfg, generator, tex_idx,
        noise_deg)
    fields = composite_ops.composite_drops(
        cfg.image_hw, buckets, lo, add_rgb,
        sat_rgb_all=gains if cfg.compute_saturation_mask else None)
    return fields, overflow


def kernel_rungs(rungs, cfg: PipelineConfig):
    """rasterize.RungParams -> the fused kernel's RasterRung operands."""
    return [RasterRung(params=r.params, anchor=r.anchor, ayc=r.ayc,
                       bxc=r.bxc,
                       n_valid=r.valid.to(torch.int32).sum(-1).to(
                           torch.int32),
                       patch_hw=(b.ph, b.pw))
            for r, b in zip(rungs, cfg.raster.buckets)]


def fused_field_planes(bg, depth, drops: DropBatch, textures, bin_edges,
                       cfg: PipelineConfig,
                       generator: Optional[torch.Generator] = None,
                       tex_idx: Optional[torch.Tensor] = None,
                       noise_deg: Optional[torch.Tensor] = None,
                       pano: Optional[torch.Tensor] = None):
    """Batched fused raster+composite up to the field planes.

    Returns (fogged, env_save, planes, overflow) with ``planes``
    (B, P, H, W) in plane order (alpha, log_att, add_r, add_g, add_b
    [, sat_r, sat_g, sat_b]) — 8 planes when
    cfg.compute_saturation_mask — and image-sized already (the JAX
    package's are padded for TPU window tiling)."""
    fogged, env_photo, env_save = frame_background(bg, depth, cfg, pano)
    rungs, overflow = drop_fused_params(env_photo, drops, textures,
                                        bin_edges, cfg, generator, tex_idx,
                                        noise_deg)
    planes = fused_raster_composite(
        kernel_rungs(rungs, cfg), cfg.image_hw,
        tuple(textures.raw.shape[1:]),
        N_PLANES_SAT if cfg.compute_saturation_mask else N_PLANES)
    return fogged, env_save, planes, overflow


def crop_field_planes(planes: torch.Tensor,
                      cfg: PipelineConfig) -> composite_ops.FieldMaps:
    """(B, 5 | 8, >=H, >=W) planes -> FieldMaps at image size."""
    h, w = cfg.image_hw
    return composite_ops.FieldMaps.from_planes(
        planes[..., :h, :w].to(torch.float32))


def finalize_frame(bg, fogged, fields: composite_ops.FieldMaps, env_save,
                   overflow, cfg: PipelineConfig) -> FrameOutput:
    """Blend fields over the fogged background, then shift each frame's
    mean back to the clear image's mean, and clip."""
    rainy = composite_ops.blend(fogged, fields)
    dims = (-3, -2, -1)
    rainy = rainy - (rainy.mean(dim=dims, keepdim=True)
                     - bg.to(torch.float32).mean(dim=dims, keepdim=True))
    rainy = torch.clamp(rainy, 0.0, 1.0)
    return FrameOutput(rainy_image=rainy, rain_mask=fields.alpha,
                       envmap=env_save, overflow=overflow,
                       saturation_mask=fields.sat)


def _render_frames_xla(bg, depth, drops: DropBatch, textures, bin_edges,
                       cfg: PipelineConfig, generator, tex_idx, noise_deg,
                       pano) -> FrameOutput:
    """The golden path over a batch: frame_background, drop_fields,
    finalize_frame."""
    fogged, env_photo, env_save = frame_background(bg, depth, cfg, pano)
    fields, overflow = drop_fields(env_photo, drops, textures, bin_edges,
                                   cfg, generator, tex_idx, noise_deg)
    return finalize_frame(bg, fogged, fields, env_save, overflow, cfg)


def render_frames(bg: torch.Tensor,
                  depth: torch.Tensor,
                  drops: DropBatch,
                  textures,
                  bin_edges: torch.Tensor,
                  cfg: PipelineConfig,
                  generator: Optional[torch.Generator] = None,
                  tex_idx: Optional[torch.Tensor] = None,
                  noise_deg: Optional[torch.Tensor] = None,
                  pano: Optional[torch.Tensor] = None) -> FrameOutput:
    """Render rain onto a batch of frames.

    bg: (B, H, W, 3) RGB in [0, 1]; depth: (B, H, W) metric depth (m);
    drops: DropBatch with leading dim B; textures: data.textures
    TextureBank (under composite_mode "xla" also a plain (K, TH, TW)
    tensor, sampled by the gather); bin_edges: (4,) texture ratio-bin
    edges. Texture picks come from ``tex_idx`` (B, N) when given, else
    from ``generator``; so does the streak noise ``noise_deg`` (B, N),
    in degrees, when the settings' noise_scale * noise_std is not 0 (see
    :func:`drop_fused_params`). ``pano`` (B, He, We, 3): the captured
    panoramas, read when the settings' env_type is 'pano'. The fields
    accumulate by cfg.resolved_composite_mode(): the fused kernel, or
    the golden path's patches and scatter ("xla").
    """
    if cfg.resolved_composite_mode() == "xla":
        return _render_frames_xla(bg, depth, drops, textures, bin_edges,
                                  cfg, generator, tex_idx, noise_deg, pano)
    fogged, env_save, planes, overflow = fused_field_planes(
        bg, depth, drops, textures, bin_edges, cfg, generator, tex_idx,
        noise_deg, pano)
    return finalize_frame(bg, fogged, crop_field_planes(planes, cfg),
                          env_save, overflow, cfg)


def render_frame(bg: torch.Tensor,
                 depth: torch.Tensor,
                 drops: DropBatch,
                 textures,
                 bin_edges: torch.Tensor,
                 cfg: PipelineConfig,
                 generator: Optional[torch.Generator] = None,
                 tex_idx: Optional[torch.Tensor] = None,
                 noise_deg: Optional[torch.Tensor] = None,
                 pano: Optional[torch.Tensor] = None) -> FrameOutput:
    """Render rain onto one frame through the golden path, whatever
    cfg.composite_mode says (as the JAX package's render_frame).

    bg (H, W, 3), depth (H, W), drops a one-frame DropBatch (N, ...),
    tex_idx / noise_deg (N,) and pano (He, We, 3) when given; the other
    arguments as :func:`render_frames`, whose draws it makes (a frame's
    draws from ``generator`` equal render_frames' on a batch of that one
    frame). Returns a FrameOutput without the batch dimension.
    """
    def one(t):
        return None if t is None else t[None]

    out = _render_frames_xla(one(bg), one(depth), drops.map(one), textures,
                             bin_edges, cfg, generator, one(tex_idx),
                             one(noise_deg), one(pano))
    return FrameOutput(**{f.name: None if getattr(out, f.name) is None
                          else getattr(out, f.name)[0]
                          for f in dataclasses.fields(out)})
