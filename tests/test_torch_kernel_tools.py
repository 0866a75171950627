"""The port's kernel tools (``tools/gpu_selfcheck``, ``kernel_anatomy``,
``kernel_ablation``), the raster kernel's ``ablate`` option and variant
builds, on the CPU at tiny shapes.

- The self-check scene: the port's CPU render of raintpu's own
  ``tpu_selfcheck.build_scene()`` drops (through ``interop``, the same
  texture picks fed to both as data) within 2e-4 of raintpu's
  ``_render_frames_fused(..., interpret=True)`` — the fused path's own
  bar (tests/test_torch_render.py) — near-field frame included; the
  port's scene config equal to raintpu's field for field.
- The fog against the float64 oracle: within 1e-5 on the CPU (the plain
  band products in float32), and the port's oracle equal to raintpu's
  inline one to 1e-12 (the same float64 arithmetic).
- The anatomy's helpers leave the planes as they were (padding) or equal
  to the first n slots' (capping); the ablation's spread anchors never
  overlap; moved windows keep their patches; the slopes are the JAX
  tool's formulas.
- ``ablate``: parsing, and no knockout on CPU tensors; the render path
  never passes it; ``cuda_build``'s production library path is the
  sha256 of source and flags, as before, and a define set moves it.
"""

import dataclasses
import hashlib
import math
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raintpu.ops import blur as jblur
from raintpu.ops import fog as jfog
from raintpu.ops import rasterize as jrz
from raintpu.render import frame as jframe
from raintpu.tools import tpu_selfcheck as jcheck
from raintpu_torch import cuda_build, interop
from raintpu_torch.ops import fused_raster as tfr
from raintpu_torch.render import frame as tframe
from raintpu_torch.tools import gpu_selfcheck as tcheck
from raintpu_torch.tools import kernel_ablation as tabl
from raintpu_torch.tools import kernel_anatomy as tanat
from raintpu_torch.tools import kernel_sass
from raintpu_torch.tools.stage_profile import HAND_LADDER
from torch_cpu_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ATOL = 2e-4
# TPU layout knobs of the JAX PipelineConfig that the port leaves out.
TPU_ONLY = {"row_strip", "pair_eval", "narrow_dma", "resident"}


@pytest.fixture(scope="module")
def jax_scene():
    return jcheck.build_scene()


@pytest.fixture(scope="module")
def port_scene():
    return tcheck.build_scene(device="cpu")


def test_selfcheck_scene_matches_raintpu(jax_scene):
    """raintpu's self-check drops, rendered by the port on the CPU and
    by raintpu's fused path in interpret mode, the same picks."""
    jcfg, (bg, depth, drops, bank, edges, keys) = jax_scene
    want = jax.jit(lambda *a: jframe._render_frames_fused(
        *a, jcfg, interpret=True))(bg, depth, drops, bank, edges, keys)
    tex_idx = jax.vmap(lambda d, k: jrz.select_textures(
        d, edges, jax.random.split(k)[0]))(drops, keys)
    tcfg, _ = tcheck.build_scene(device="cpu")
    got = tframe.render_frames(
        torch.as_tensor(np.array(bg)), torch.as_tensor(np.array(depth)),
        interop.drop_batch_from_numpy(interop.numpy_fields(drops),
                                      device="cpu"),
        interop.texture_bank_from_numpy(bank.raw, bank.ay, bank.bx,
                                        device="cpu"),
        torch.as_tensor(np.array(edges)), tcfg,
        tex_idx=torch.as_tensor(np.array(tex_idx)))
    mask = got.rain_mask.numpy()
    assert np.all(np.isfinite(mask))
    # Rain in the standard frame and in the near-field frame.
    assert (mask.reshape(mask.shape[0], -1).sum(1) > 1.0).all()
    np.testing.assert_allclose(mask, np.asarray(want.rain_mask), atol=ATOL)
    np.testing.assert_allclose(got.rainy_image.numpy(),
                               np.asarray(want.rainy_image), atol=ATOL)
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))


def test_selfcheck_config_matches_raintpu(jax_scene, port_scene):
    jd = dataclasses.asdict(jax_scene[0])
    td = dataclasses.asdict(port_scene[0])
    assert set(jd) - set(td) == TPU_ONLY
    assert {k: v for k, v in jd.items() if k not in TPU_ONLY} == td
    bg, depth, drops, tex, edges, tex_idx = port_scene[1]
    assert tuple(bg.shape) == (2, 96, 256, 3)
    assert tuple(tex_idx.shape) == tuple(drops.valid.shape)
    # The last frame is the near-field population: every drop at a depth
    # (world z in the renderer's convention) of at most 2 m.
    last = drops.map(lambda t: t[-1])
    z = torch.stack([last.wp1[:, 2], last.wp2[:, 2]])[:, last.valid]
    assert last.valid.sum() > 0 and 0.0 < float(z.min())
    assert float(z.max()) <= 2.0


def _jax_inline_oracle(img, depth):
    """raintpu/tools/tpu_selfcheck.py's inline float64 oracle, with
    raintpu's helpers."""
    i64, d64 = img.astype(np.float64), depth.astype(np.float64)
    f_ext = np.exp(-jfog.beta_ext(10.0) * d64 / 1000.0)
    irr = 4.0 * 36.0 * i64 / (2e-3 * 20.0 * math.pi)
    c = jfog.beta_hg(90.0) * irr.reshape(-1, 3).mean(0)
    l_in = np.clip(c[None, None] * (1.0 - f_ext)[..., None], 0, 1)
    k = jblur.cv2_gaussian_kernel(25, 25.0)
    kk = ("f64oracle", 25)
    kh = jblur._blur_matrix(img.shape[0], kk, k).astype(np.float64)
    kw = jblur._blur_matrix(img.shape[1], kk, k).astype(np.float64)

    def blur64(x):
        return np.einsum("ij,jw->iw", kh, np.einsum("hj,oj->ho", x, kw))

    f_ext_b = blur64(f_ext)
    l_in_b = np.stack([blur64(l_in[..., ch]) for ch in range(3)], -1)
    return np.clip(i64 * f_ext_b[..., None] + l_in_b, 0, 1)


def test_fog_precision_check_on_the_cpu():
    assert tcheck.fog_precision_check(48, 128, device="cpu") <= 1e-5
    rng = np.random.RandomState(3)
    img = rng.rand(48, 128, 3).astype(np.float32)
    depth = rng.rand(48, 128).astype(np.float32) * 80 + 2
    np.testing.assert_allclose(tcheck.fog_f64_oracle(img, depth),
                               _jax_inline_oracle(img, depth),
                               atol=1e-12, rtol=0)
    assert tcheck.FOG_F64_BOUND == jcheck.FOG_F64_BOUND


@pytest.fixture(scope="module")
def rungs(port_scene):
    cfg, (bg, depth, drops, tex, edges, tex_idx) = port_scene
    _, env, _ = tframe.frame_background(bg, depth, cfg)
    params, _ = tframe.drop_fused_params(env, drops, tex, edges, cfg,
                                         tex_idx=tex_idx)
    return tframe.kernel_rungs(params, cfg), cfg, tuple(tex.raw.shape[1:])


def test_pad_rung_leaves_the_planes(rungs):
    rs, cfg, tex_hw = rungs
    for r in rs:
        cap = r.params.shape[2]
        padded = tanat.pad_rung(r, 2 * cap)
        assert padded.params.shape[2] == 2 * cap
        assert torch.equal(padded.n_valid, r.n_valid)
        assert torch.equal(
            tfr.fused_raster_composite([padded], cfg.image_hw, tex_hw),
            tfr.fused_raster_composite([r], cfg.image_hw, tex_hw))
    with pytest.raises(ValueError):
        tanat.pad_rung(rs[0], 1)


@pytest.mark.parametrize("n", [0, 3, 10])
def test_cap_valid_renders_the_first_slots(rungs, n):
    rs, cfg, tex_hw = rungs
    r = rs[0]
    first = dataclasses.replace(
        r, params=r.params[:, :, :n].contiguous(),
        anchor=r.anchor[:, :n].contiguous(), ayc=r.ayc[:, :n].contiguous(),
        bxc=r.bxc[:, :n].contiguous(),
        n_valid=torch.clamp(r.n_valid, max=n).contiguous())
    got = tfr.fused_raster_composite([tanat.cap_valid(r, n)], cfg.image_hw,
                                     tex_hw)
    if n == 0:
        assert not got.any()
        return
    want = tfr.fused_raster_plain([first], cfg.image_hw, tex_hw)
    assert torch.equal(got, want)
    assert tanat.mean_valid([tanat.cap_valid(r, n)]) == float(
        torch.clamp(r.n_valid, max=n).double().mean())


@pytest.mark.parametrize("spec", HAND_LADDER, ids=lambda s: f"{s.ph}x{s.pw}")
def test_spread_anchors_never_overlap(spec):
    image_hw = (375, 1242)
    grid = tabl.spread_anchors(spec.capacity, (spec.ph, spec.pw), image_hw)
    assert grid.shape == (spec.capacity, 2) and grid.dtype == np.int32
    assert not tabl.windows_overlap(grid, (spec.ph, spec.pw))
    assert (grid[:, 0] + spec.pw <= image_hw[1]).all()
    assert (grid[:, 1] + spec.ph <= image_hw[0]).all()
    chain = np.broadcast_to(np.asarray(tabl.CHAIN_ANCHOR, np.int32),
                            (spec.capacity, 2))
    assert tabl.windows_overlap(chain, (spec.ph, spec.pw))
    with pytest.raises(ValueError):
        tabl.spread_anchors(10_000, (spec.ph, spec.pw), image_hw)


def test_windows_overlap_sees_one_shared_pixel():
    assert tabl.windows_overlap(np.array([[0, 0], [31, 23]]), (24, 32))
    assert not tabl.windows_overlap(np.array([[0, 0], [32, 0]]), (24, 32))
    assert not tabl.windows_overlap(np.array([[0, 0], [0, 24]]), (24, 32))


def test_moved_windows_keep_their_patches(rungs):
    rs, cfg, tex_hw = rungs
    r = rs[0]
    cap = r.params.shape[2]
    # KITTI's frame holds the grid; the patches need no image.
    grid = tabl.spread_anchors(cap, r.patch_hw, (375, 1242))
    moved = tabl.moved_rung(r, grid)
    assert (moved.anchor == torch.as_tensor(grid)[None]).all()
    torch.testing.assert_close(tfr._patch_eval(moved, *tex_hw),
                               tfr._patch_eval(r, *tex_hw),
                               atol=1e-5, rtol=0)


def test_slopes_are_the_jax_formulas():
    # raintpu/tools/kernel_anatomy.py:146-151 and :154-155, on given rows.
    B = 48
    rows = [(0, 0.0, 0.2443), (56, 83.9, 0.3064), (112, 164.6, 0.4247),
            (224, 236.6, 0.5037)]
    (n0, m0, t0_), (n1, m1, t1_) = rows[0], rows[-1]
    assert tanat.valid_slope(rows, B) == (t1_ - t0_) * 1000.0 / (
        (m1 - m0) * B)
    ms2, cap = 0.2453, 336
    assert tanat.gated_slope(t0_, ms2, cap, B) == (ms2 - t0_) * 1000.0 / (
        cap * B)
    assert tanat.valid_slope([(0, 5.0, 0.1), (8, 5.0, 0.2)], B) is None


def test_raster_bound_counts(rungs):
    rs, cfg, _ = rungs
    ms, by, px = tanat.raster_bound(rs, cfg.image_hw, tfr.N_PLANES)
    assert by in ("bytes", "operations") and ms > 0 and px > 0
    planes = rs[0].params.shape[0] * tfr.N_PLANES * 96 * 256 * 4
    assert ms >= planes / tanat.PEAK_BYTES * 1e3


def test_ablate_names():
    assert tfr.ablate_bits("") == 0
    assert tfr.ablate_defines("") == ()
    assert tfr.ablate_bits("noeval+noplace") == 3
    assert tfr.ablate_defines("noeval+noaccum+nowrite") == (
        "RAINTPU_ABLATE=13",)
    assert tfr.ablate_bits(
        "noeval+noplace+noaccum+nowrite+nostage") == 31
    for bad in ("noroll", "noeval+noread", "nostage", "nostage+noeval",
                "noeval+noeval", "nordwait"):
        with pytest.raises(ValueError):
            tfr.ablate_bits(bad)
    # Every ladder line names a valid set.
    assert [tfr.ablate_bits(a) for _, a, _, _ in tabl.LADDER] == [
        0, 1, 3, 5, 13, 31]


def test_ablate_refuses_cpu_tensors(rungs):
    rs, cfg, tex_hw = rungs
    with pytest.raises(ValueError, match="only in"):
        tfr.fused_raster_composite(rs, cfg.image_hw, tex_hw, ablate="noeval")
    with pytest.raises(ValueError):
        tfr.fused_raster_composite(rs, cfg.image_hw, tex_hw, ablate="noroll")
    assert torch.equal(
        tfr.fused_raster_composite(rs, cfg.image_hw, tex_hw, ablate=""),
        tfr.fused_raster_plain(rs, cfg.image_hw, tex_hw))


def test_the_render_path_never_passes_ablate():
    pkg = REPO / "raintpu_torch"
    files = (sorted((pkg / "render").glob("*.py"))
             + [pkg / "cli.py", pkg / "tools" / "bench_suite.py",
                pkg / "tools" / "stage_profile.py"])
    for f in files:
        assert not re.search(r"\bablate\b", f.read_text()), f


def test_cuda_build_paths():
    src = cuda_build.CSRC / "fused_raster.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        cuda_build.NVCC_FLAGS).encode()).hexdigest()
    plain = cuda_build.BUILD_DIR / f"fused_raster-{digest[:16]}.so"
    assert cuda_build.library_path("fused_raster") == plain
    assert cuda_build.library_path("fused_raster", ()) == plain
    three = cuda_build.library_path("fused_raster", ("RAINTPU_ABLATE=3",))
    five = cuda_build.library_path("fused_raster", ("RAINTPU_ABLATE=5",))
    assert len({plain, three, five}) == 3
    digest3 = hashlib.sha256(src.read_bytes() + " ".join(
        cuda_build.NVCC_FLAGS + ("-DRAINTPU_ABLATE=3",)).encode()).hexdigest()
    assert three.name == f"fused_raster-{digest3[:16]}.so"
    xml = cuda_build.CSRC / "xmlparse.cc"
    digest_xml = hashlib.sha256(xml.read_bytes() + " ".join(
        cuda_build.GXX_FLAGS).encode()).hexdigest()
    assert cuda_build.library_path("xmlparse").name == (
        f"xmlparse-{digest_xml[:16]}.so")
    with pytest.raises(ValueError):
        cuda_build.build_all(["fused_raster", "fused_raster"], [()])


@pytest.mark.parametrize("tool", [tanat, tabl],
                         ids=["kernel_anatomy", "kernel_ablation"])
def test_tools_time_only_on_the_card(tool, rungs):
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu"])
    rs, cfg, tex_hw = rungs
    with pytest.raises(ValueError):
        tanat.launch_ms(rs, cfg.image_hw, tex_hw)


def test_selfcheck_needs_the_card():
    assert tcheck.main(["--device", "cpu"]) == 2


def test_sass_listing_helpers():
    listing = (
        "\tcode for sm_90a\n"
        "\t\tFunction : _ZN12_GLOBAL__N_19kernelILi4EEEv\n"
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;\n"
        "        /*0010*/              @!P0 BRA 0x40b70 ;\n"
        "        /*10000*/                  MUFU.COS R2, R3 ;\n"
        "\t\tFunction : _ZN12_GLOBAL__N_19kernelILi8EEEv\n"
        "        /*0000*/                   STG.E [R2.64], R4 ;\n")
    mix = kernel_sass.opcode_mix(listing)
    assert list(mix) == ["_ZN12_GLOBAL__N_19kernelILi4EEEv",
                         "_ZN12_GLOBAL__N_19kernelILi8EEEv"]
    first, second = mix.values()
    assert first == {"MOV": 1, "BRA": 1, "MUFU": 1}
    assert second == {"STG": 1}
    other = listing.replace("_ZN12_GLOBAL__N_1", "_ZN48_GLOBAL__N__b89_")
    assert other != listing
    assert kernel_sass.bodies(other) == kernel_sass.bodies(listing)
    assert list(kernel_sass.bodies(listing)) == ["<4, float>", "<8, float>"]
    # The planes' type, where the name has it (bfloat16 planes).
    bf16 = listing.replace("ILi8EEEv", "ILi8E13__nv_bfloat16EEv").replace(
        "ILi4EEEv", "ILi4EfEEv")
    assert list(kernel_sass.bodies(bf16)) == ["<4, float>", "<8, bf16>"]
