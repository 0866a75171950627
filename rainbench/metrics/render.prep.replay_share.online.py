"""render.prep.replay_share.online (%): render.prep.replay_share in an
online cell, the same reading as metrics/render.prep.replay_share.py.
There the step's rate stands per layer (online.images_per_s), so this
metric moves step_ms_p95."""

from rainbench import spec


def read(run):
    return spec.reader("render.prep.replay_share").read(run)
