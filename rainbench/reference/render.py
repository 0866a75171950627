"""The plain reference render: what the benchmark holds the program's
outputs to.

Plain PyTorch, frozen with the benchmark. It imports nothing of the
program and takes nothing the program made: from the run's inputs
(frames, depth maps, drops, texture picks, the raw streak textures and
the configuration's camera) it works out again the texture bank's DCT
factors, the ladder of windows fitted to the pool, the fog, the
envmaps, every drop's colour, warp, defocus and series, the planes and
the finished frames. Matmuls run in float32 with TF32 off.

The model is the one the program renders (the physics strategy with
the extrapolated envmap, no streak noise, five planes): each stage's
module says what it computes.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from rainbench.reference import background, photometry, streaks, textures

ENV_DOWNSAMPLE = 4
ENV_FOLD_MIN = 6
OPACITY = 1.0
TAU_ZERO = math.sqrt(1.16e-3) / 50.0


def downsamples(image_hw, cone_downsample: int):
    """(envmap downsample, feature downsample): the largest divisor f
    of cone_downsample that keeps the photometry envmap at >= 6 texels
    an axis moves into the envmap's own downsample."""
    cds = max(int(cone_downsample), 1)
    f = cds
    while f > 1 and (cds % f != 0
                     or min(image_hw) // (ENV_DOWNSAMPLE * f) < ENV_FOLD_MIN):
        f -= 1
    return ENV_DOWNSAMPLE * f, cds // f


class Reference:
    """The reference for one run: the bank's factors and the ladder
    fitted to the whole pool, then :meth:`render` on any of its frames.

    ``settings``: the configuration's camera settings (the dataset
    plugin's dict); ``pool``: a :class:`rainbench.inputs.Pool`."""

    def __init__(self, settings: dict, fallrate: float,
                 cone_downsample: int, save_envmap: bool, pool):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.focal_mm = float(settings["cam_focal"])
        self.f_number = float(settings["cam_f_number"])
        self.exposure_s = float(settings["cam_exposure"]) * 1e-3
        self.gain = float(settings["cam_gain"])
        self.fallrate = float(fallrate)
        self.cone_downsample = int(cone_downsample)
        self.save_envmap = bool(save_envmap)
        self.image_hw = tuple(pool.bg.shape[-3:-1])
        self.tex_hw = tuple(pool.textures.shape[1:])
        dev = pool.bg.device
        ay, bx = textures.factors(pool.textures)
        self.ay = torch.as_tensor(ay, device=dev)
        self.bx = torch.as_tensor(bx, device=dev)
        flat = {k: v.reshape((-1,) + v.shape[2:])
                for k, v in pool.drops.items()}
        nw, nh, s4 = (t.cpu().numpy()
                      for t in streaks.needs(self._geometry(flat)))
        self.ladder = streaks.fit_ladder(nw, nh, s4,
                                         flat["valid"].cpu().numpy())

    def _geometry(self, drops):
        h, w = self.image_hw
        return streaks.geometry(drops, self.tex_hw, (w, h),
                                focal_m=self.focal_mm / 1000.0,
                                f_number=self.f_number)

    def render(self, bg: torch.Tensor, depth: torch.Tensor,
               drops: Dict[str, torch.Tensor],
               tex_idx: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        """Frames (B, H, W, 3), depths (B, H, W), drops and picks of
        those frames -> rainy_image (B, H, W, 3), rain_mask (B, H, W)
        and, when the run saves it, envmap (B, H, W_env, 3)."""
        fogged = background.fog(bg, depth, fallrate=self.fallrate,
                                f_number=self.f_number,
                                exposure_s=self.exposure_s, gain=self.gain)
        gen_ds, feat_ds = downsamples(self.image_hw, self.cone_downsample)
        env_photo = background.envmap(background.avg_pool(fogged, gen_ds),
                                      self.focal_mm)
        env_save = (background.envmap(fogged, self.focal_mm)
                    if self.save_envmap else None)
        gains = photometry.drop_gains(env_photo,
                                      (drops["wp1"] + drops["wp2"]) / 2.0,
                                      feat_ds)
        d_avg = (drops["iw1"] + drops["iw2"]) / 2.0
        lo = OPACITY * d_avg / (drops["length"].to(d_avg.dtype) + d_avg)
        add_rgb = gains * (self.exposure_s * lo / TAU_ZERO)[..., None]
        planes = streaks.fields(drops, self._geometry(drops), tex_idx,
                                self.ay, self.bx, self.tex_hw,
                                self.image_hw, self.ladder, lo, add_rgb)
        rainy = torch.clamp(torch.exp(planes[:, 1])[..., None] * fogged
                            + torch.movedim(planes[:, 2:5], 1, -1), 0.0, 1.0)
        dims = (-3, -2, -1)
        rainy = torch.clamp(rainy - (rainy.mean(dim=dims, keepdim=True)
                                     - bg.mean(dim=dims, keepdim=True)),
                            0.0, 1.0)
        return dict(rainy_image=rainy, rain_mask=planes[:, 0],
                    envmap=env_save)
