"""The controls at each cell's own size, on the card: the reference put in
the program's place in the nearest lower precision must fail one of the
cell's limits, and so must each fault (perfbench/controls.py).  They skip
without a card:

    python -m pytest perfbench/tests/test_perfbench_controls.py -m gpu -q
"""
import pytest
import torch

from perfbench import controls
from perfbench import run as runner

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _failed(ctx, readings, prefix=""):
    return [n for n, lim in ctx.limits.items() if readings.get(prefix + n, 0.0) > lim]


def test_serving_control_and_altered_token_fail(cuda):
    ctx = runner.context("serve.rgb2depth.b8", 104, 0.0, False, cuda)
    out = controls.serve_controls(ctx)
    assert _failed(ctx, out)
    assert out["fault_altered_token_gap_max"] > ctx.limits["gap_max"]


@pytest.mark.parametrize("cell", ["train.base.b8", "train.large.b4", "train.base.dp4"])
def test_training_control_and_half_batch_fail(cuda, cell):
    ctx = runner.context(cell, 104, 0.0, False, cuda)
    out = controls.train_controls(ctx)
    assert _failed(ctx, out, "control_")
    assert _failed(ctx, out, "fault_half_batch_")
    if ctx.traffic["world"] > 1:
        assert _failed(ctx, out, "fault_no_exchange_")
