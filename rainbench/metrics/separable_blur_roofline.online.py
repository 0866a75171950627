"""separable_blur_roofline.online (%): separable_blur_roofline in an online
cell, the same reading as metrics/separable_blur_roofline.py. There the
step's rate stands per layer (online.images_per_s), so this metric moves
step_ms_p95."""

from rainbench import spec


def read(run):
    return spec.reader("separable_blur_roofline").read(run)
