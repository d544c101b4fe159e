"""On the card: each cell's control, the program's own TF32 path (the
port's ``default`` precision, the step below the configurations' fp32
with TF32 off), fails the output check at the cell's own size, where the
program as configured passes it. Marked ``cuda``: skips off the card.

    python -m pytest --noconftest -p no:cacheprovider stereo_bench/tests/test_bench_control.py -q
"""

import pytest

WORKLOADS = ["madnet-mad-stream", "dispnet-full-stream", "madnet-none-stream", "madnet-mad-rig4"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 runs on the card alone")
    torch.set_num_threads(1)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_and_the_program_passes(card, workload):
    from stereo_bench.calibrate import CONTROL
    from stereo_bench.harness import run_cell

    control = run_cell(workload, 2**31 + 101, 1.0, False, "cuda", precision=CONTROL)
    assert not control["correct"], control["checks"]
    sound = run_cell(workload, 2**31 + 101, 1.0, False, "cuda")
    assert sound["correct"], sound["checks"]
