"""The control comes out not correct: the reference put in the program's
place and computed in the precision below the configuration's (float8
e4m3 where merlot-base computes in bf16; TF32 where grover-medium computes
in float32), judged with the cell's own limits. At the size a test can
hold: the published width with fewer layers (and on the card for TF32,
which the CPU does not have). The program at the same size passes."""

import pytest
import torch

from benchmark.harness import compare
from benchmark.harness.cell import tf32
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(8)


def training(cell):
    cell.setup()
    cell.release()
    with tf32(False):
        ref = cell.reference_run()
    limits = cell.ctx.limits
    return (compare.training_checks(cell.program_readings(), ref, limits),
            compare.training_checks(cell.control_run(), ref, limits))


def test_pretrain_control_fails():
    program, control = training(tiny_cell("merlot-base.pretrain", width=768, layers=2))
    assert compare.passed(program), program
    assert not compare.passed(control), control


def test_zero_shot_control_fails():
    cell = tiny_cell("merlot-base.zeroshot", width=768, layers=4)
    cell.setup()
    outs = [cell.step()[1] for _ in range(3)]
    cell.release()
    program = cell.check(outs)
    ctrl = cell.control_run()
    picked = cell.judged(len(outs))
    gap = compare.rows_max_gap([ctrl[outs[j][0]] for j in picked],
                               [cell.reference_probs()[outs[j][0]] for j in picked])
    assert compare.passed(program), program
    assert gap > cell.ctx.limits["prob_gap"], gap


@pytest.mark.gpu
def test_grover_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32")
    cell = tiny_cell("grover-medium.train", width=1024, layers=4)
    cell.ctx = type(cell.ctx)(**{**cell.ctx.__dict__, "device": torch.device("cuda")})
    cell.dev = cell.ctx.device
    cell.ctx.params.update(batch=2, seq=512)
    program, control = training(cell)
    assert compare.passed(program), program
    assert not compare.passed(control), control
