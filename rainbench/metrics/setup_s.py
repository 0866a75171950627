"""setup_s (s): from the first line of rainbench/run.py to the window's
start (host clock):
imports, CUDA context, kernel build or load, the pool, the program's
bank and fit, and one warm step of each pool batch."""


def read(run):
    return run.setup_s
