"""step_ms_p95 (ms): the 95th percentile (numpy's linear) of every
step's time in the window, each from its start to its synchronize."""

import numpy as np


def read(run):
    return 1000.0 * float(np.percentile(run.step_s, 95))
