"""render.fog.host_ms.online (ms): render.fog.host_ms in an online cell,
the same reading as metrics/render.fog.host_ms.py. There the step's rate
stands per layer (online.images_per_s), so this metric moves
step_ms_p95."""

from rainbench import spec


def read(run):
    return spec.reader("render.fog.host_ms").read(run)
