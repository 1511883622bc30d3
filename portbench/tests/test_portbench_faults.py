"""The check that decides ``correct`` catches what it must: whole small
runs of each cell, with the look for a card skipped, come out not
correct when the timed path is broken underneath, and (on a card) when
the lower-precision control stands in the program's place."""

import pytest

from portbench import harness
from portbench.tests import cells

# every cell file, those that BENCHMARK.json does not run yet too
CELLS = sorted(p.stem for p in (harness.ROOT / "workloads").glob("*.json"))
FAULTS = {"train": ("half_batch", "stale_state"),
          "open_loop": ("answer", "half_batch"),
          "closed_batch": ("answer", "half_batch")}
CASES = [(c, f) for c in CELLS for f in FAULTS[harness.workload(c)["kind"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, one_thread):
    out = cells.run(cell, fault=fault)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_small_run_is_correct(cell, one_thread):
    out = cells.run(cell)
    assert out["correct"] is True, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_correct_on_card(cell, cuda_device):
    out = cells.run(cell, device=cuda_device, seconds=2.0, seed=2 ** 31 + 3,
                    sizes=cells.CARD, full_image=True)
    assert out["correct"] is True, out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_on_card(cell, cuda_device):
    out = cells.run(cell, device=cuda_device, seconds=2.0, seed=2 ** 31 + 4,
                    sizes=cells.CARD, full_image=True, control=True)
    assert out["correct"] is False, out["checks"]
