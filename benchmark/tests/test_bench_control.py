"""On the card: the control (the reference in the program's place, in
TF32) and the planted faults fail the check's limits of every cell, at the
cell's batch on a smaller corpus.  Run with ``python3 -m pytest
benchmark/tests -m cuda``."""

import pytest

from benchmark import control, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_limits(name, card, tmp_path):
    cell = spec.cell(name)
    cell.update(train_videos=60, val_videos=10)
    out = control.readings(cell, 2**31 + 5, control.VARIANTS,
                           root=str(tmp_path / "run"))
    for variant, numbers in out.items():
        failed = [k for k, limit in cell["limits"].items()
                  if k in numbers and numbers[k] > limit]
        assert failed, (variant, numbers)
