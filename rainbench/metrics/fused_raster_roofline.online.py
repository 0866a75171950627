"""fused_raster_roofline.online (%): fused_raster_roofline in an online
cell, the same reading as metrics/fused_raster_roofline.py. There the
step's rate stands per layer (online.images_per_s), so this metric moves
step_ms_p95."""

from rainbench import spec


def read(run):
    return spec.reader("fused_raster_roofline").read(run)
