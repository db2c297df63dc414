"""The control, the reference computed in float8 in the program's place,
comes out not correct under each cell's limits, at a size a test run
holds; so does the planted half-batch fault in the reference. On the card
(``chip``) the same comparison runs at the cells' own sizes."""
import pytest
import torch

from bench import control
from bench.harness import check, spec
from bench.tests import tiny

SIZE = dict(tiny.DENSE, hidden_size=256, intermediate_size=512,
            num_attention_heads=8, num_key_value_heads=2, head_dim=32,
            vocab_size=512)


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2])
def test_control_and_half_batch_fail(cell, seed):
    tr = dict(spec.traffic(cell), batch=4, seq=128)
    dev = torch.device("cpu")
    plan = control.checked_steps(tr, SIZE, seed, dev)
    batches, mode = plan["batches"], tr["reference_mode"]
    ref = check.run_reference(SIZE, seed, dev, batches, plan["hp"],
                              plan["names"], mode)
    ref["grad"] = ref[plan["grad"]]
    for feed, m in ((batches, "fp8"),
                    ([control.half_batch(b) for b in batches], mode)):
        got, _, _ = control.side_readings(SIZE, seed, dev, plan, feed, m,
                                          ref)
        ok, checks = check.verdict(got, tr["limits"])
        assert not ok, checks


@pytest.mark.chip
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = control.control_readings(cell, 2 ** 31 + 7)
    limits = spec.traffic(cell)["limits"]
    for name in ("control", "fault_half"):
        ok, checks = check.verdict(got[name], limits)
        assert not ok, (name, checks)
