"""The reference held to the program's plain path at a small size, and
the control that the limits must fail.

On the CPU every kernel of the program runs its plain PyTorch version:
the reference has to agree with it to rounding. The control, the
program with bfloat16 field planes, comes out not correct by every
cell's limits. The card-only test runs the program and each control
its cell's limits name (``controls``) at the cell's own size."""

import pytest

from rainbench import calibrate, check, harness, spec
from rainbench.tests.conftest import CELLS, tiny

SEED = 2 ** 40 + 99


def _verdict(cell, control):
    _, prog, kept = harness.setup(cell, SEED, "cpu", control)
    return check.judge(cell, prog.judged(), kept, SEED, prog.truncated())


@pytest.mark.parametrize("name", ["kitti-10mm", "kitti-200mm",
                                  "nuscenes-100mm", "kitti-10mm-envmap",
                                  "nuscenes-10mm", "kitti-online-25mm",
                                  "cityscapes-25mm-envmap"])
def test_reference_matches_plain_path(name):
    got = _verdict(tiny(name, check_frames=2), None).numbers
    assert got["frames"] == 2 * 3
    assert got["mask_max"] < 1e-6
    assert got["image_max"] < 1e-6
    assert got["image_mean"] < 1e-7
    assert got.get("envmap_max", 0.0) == 0.0
    assert got["overflow"] == 0


@pytest.mark.parametrize("name", ["kitti-10mm", "kitti-200mm",
                                  "nuscenes-100mm", "nuscenes-10mm",
                                  "kitti-online-25mm",
                                  "cityscapes-25mm-envmap"])
def test_control_fails_the_limits(name):
    verdict = _verdict(tiny(name), "bf16")
    assert verdict.correct is False
    held = spec.cell(name).limits["numbers"]
    assert any(verdict.numbers[k] > v["limit"] for k, v in held.items())


def test_every_cell_holds_the_bf16_control():
    for name in CELLS:
        assert "bf16" in spec.cell(name).limits["controls"], name


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_at_cell_size(card, name):
    cell = spec.cell(name)
    sound = calibrate.reading(cell, 5)
    assert sound["correct"] is True
    for control in cell.limits["controls"]:
        assert calibrate.reading(cell, 6, control)["correct"] is False
