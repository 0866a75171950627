"""device.idle_share (%): the share of a step in which no CUDA kernel,
copy or fill runs: 1 - the device-profile's busy seconds a step (the
union of their intervals) / the mean step of the window's untraced
steps. The untraced steps, not the profiled ones, give the step's
length: recording slows the host's launches."""


def read(run):
    v = run.view
    untraced = run.step_s[run.profiled_steps:]
    if v is None or not v.device_ops or not untraced:
        return None
    return 100.0 * (1.0 - (v.busy_s / v.steps)
                    / (sum(untraced) / len(untraced)))
