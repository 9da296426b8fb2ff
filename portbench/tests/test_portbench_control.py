"""The lower-precision control: the plain reference put in the program's
place in TF32 (operands of every matmul and convolution rounded to TF32,
TF32 on) must come out not correct, where a sound call of the program
comes out correct.  On the CPU at a small size for the two scanned
cells; on the card at the cells' own size (a trajectory or a sweep and
two references take seconds on an H100), on a machine with the card:

    PYTHONPATH=src python3 -m pytest -q portbench/tests -m card
"""
import pytest

from conftest import ROOT


def _verdicts(cell, device):
    from portbench import control
    from portbench.reference.check import verdict

    rows = {r["kind"]: r for r in control.readings(
        cell, 1234, ["sound", "tf32"], device)}
    return {kind: verdict({k: v for k, v in row.items()
                           if k in cell.limits}, cell.limits)[0]
            for kind, row in rows.items()}


@pytest.mark.parametrize("name", ["mnist-cwfl-scan", "cifar-cwfl-scan"])
def test_tf32_control_is_not_correct_at_small_size(name, tiny_root,
                                                   cpu_threads):
    import torch

    from portbench import harness

    verdicts = _verdicts(harness.load_cell(tiny_root, name),
                         torch.device("cpu"))
    assert verdicts == {"sound": True, "tf32": False}


@pytest.mark.card
@pytest.mark.parametrize("name", ["mnist-cwfl-scan", "cifar-cwfl-scan",
                                  "mnist-snr-sweep", "mnist-churn-sweep"])
def test_tf32_control_is_not_correct_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' own size")
    from portbench import harness

    verdicts = _verdicts(harness.load_cell(ROOT, name), torch.device("cuda"))
    assert verdicts == {"sound": True, "tf32": False}
