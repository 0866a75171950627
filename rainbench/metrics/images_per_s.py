"""images_per_s (images/s): frames completed in the window over the
window's seconds (host clock, every step ending in a synchronize)."""


def read(run):
    return run.frames / run.window_s
