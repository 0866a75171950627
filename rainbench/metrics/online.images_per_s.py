"""online.images_per_s (images/s): frames completed over the seconds of
the window's untraced steps, each from its start to its synchronize, in
an online cell. The host issues that cell's step and its speed moves
the rate by more than a bound can hold, so there the rate stands per
layer; the end-to-end images_per_s is the pool cells'."""


def read(run):
    untraced = run.step_s[run.profiled_steps:]
    if not untraced:
        return None
    return run.cell.batch * len(untraced) / sum(untraced)
