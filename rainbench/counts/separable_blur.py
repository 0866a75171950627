"""The least work of the fog's blur launch (K4) of one render step:
the (4B, H, W) float32 stack of each frame's extinction and three
in-scattering planes read once and written once, and the reference's
25-tap Gaussian on both axes, a multiply and an add a tap."""

from __future__ import annotations

from rainbench.reference.background import FOG_KSIZE

NAME = "separable_blur_kernel"
# The program's count of the kernel's launches.
COUNTER = "raintpu_torch.ops.blur_kernel.separable_blur"


def count(step) -> tuple:
    """(operations, bytes) of one step's launch."""
    h, w = step.image_hw
    px = 4 * step.drops["valid"].shape[0] * h * w
    return px * 2 * FOG_KSIZE * 2, 2 * px * 4
