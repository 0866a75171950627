"""rainbench: the benchmark of raintpu_torch (see README.md)."""
