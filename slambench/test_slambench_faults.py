"""The comparison that decides ``correct`` fails what it must: each planted
fault, and the control, run through the rest of a run (the harness's look
for a chip skipped) with the cell's own limits, at a size the CPU holds.
The control's readings at the cells' own sizes on the card are in PERF.md
(``test_control_at_the_cells_size`` makes them)."""

import json

import pytest
import torch

from slambench import controls, run, small

CELLS = run.cells()
SEED = 2**31 + 77


def _seconds(cell):
    """Long enough for the live tracker to move well past the limits on
    the CPU (about 30 frames); one pass for the others."""
    return 4.0 if cell.endswith("live") else 1.0


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", controls.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = small.run(small.spec(cell), SEED, _seconds(cell),
                    plant=lambda d: controls.fault(d, fault))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_small_run_is_correct(cell):
    out = small.run(small.spec(cell), SEED, _seconds(cell))
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = small.run(small.spec(cell), SEED, _seconds(cell),
                    plant=controls.depth_bf16)
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size(cell):
    """On the card: the control at the cell's own size and load, on three
    seeds, is never correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = run.load_cell(cell)
    for seed in (SEED, SEED + 1, SEED + 2):
        out = small.run(spec, seed, spec["run_seconds"], "cuda:0",
                        plant=controls.depth_bf16)
        print(cell, seed, json.dumps(out["checks"]))
        assert out["correct"] is False
