"""device.idle_share.online (%): device.idle_share in an online cell, the
same reading as metrics/device.idle_share.py. There the step's rate
stands per layer (online.images_per_s), so this metric moves
step_ms_p95."""

from rainbench import spec


def read(run):
    return spec.reader("device.idle_share").read(run)
