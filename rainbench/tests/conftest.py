"""Fixtures of the benchmark's own tests (run them with
``python -m pytest rainbench/tests``; the card-only ones, marked
``gpu``, with ``python -m pytest -m gpu rainbench/tests`` on the card).
"""

import copy

import pytest
import torch

from rainbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
# A CPU-sized cell: the configuration's camera and optics on a 320x96
# rendered frame, two frames a batch, three batches. A configuration
# that renders at a scale keeps it: its camera is render_scale times the
# frame.
TINY_HW = (96, 320)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny(name: str, batch: int = 2, pool_batches: int = 3,
         check_frames: int = 2, config: str = None) -> spec.Cell:
    """Cell ``name`` at a CPU size: its files (with ``config``, that
    configuration's in place of its own), a 320x96 rendered frame."""
    cell = copy.deepcopy(spec.cell(name))
    if config is not None:
        cell.config = spec.config(config)
    s = cell.config["settings"]
    rs = int(s.get("render_scale", 1))
    s["cam_WH"] = s["cam_CCD_WH"] = [TINY_HW[1] * rs, TINY_HW[0] * rs]
    cell.traffic.update(batch=batch, pool_batches=pool_batches,
                        check_frames_per_batch=check_frames, trace_steps=2)
    return cell
