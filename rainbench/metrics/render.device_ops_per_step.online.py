"""render.device_ops_per_step.online (ops/step): render.device_ops_per_step
in an online cell, the same reading as
metrics/render.device_ops_per_step.py. There the step's rate stands per
layer (online.images_per_s), so this metric moves step_ms_p95."""

from rainbench import spec


def read(run):
    return spec.reader("render.device_ops_per_step").read(run)
