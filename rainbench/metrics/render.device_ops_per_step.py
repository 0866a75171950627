"""render.device_ops_per_step (ops/step): CUDA kernels, copies and
fills in the traced window over the render steps traced."""


def read(run):
    v = run.view
    if v is None or not v.device_ops:
        return None
    return len(v.device_ops) / v.steps
