"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, once for each fault a training cell can have on one card (a
step that returns its state unchanged; half of the batch left out, the
mean taken over the rest). The cells' own limits judge."""
import copy

import pytest
import torch

from bench import run as bench_run
from bench.control import half_batch
from bench.tests import tiny


def unchanged(step):
    """The step computes its loss and hands back the state it was given."""
    def broken(state, batch):
        saved = copy.deepcopy(state)
        state, metrics = step(state, batch)
        with torch.no_grad():
            _restore(state, saved)
        return state, metrics
    return broken


def _restore(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _restore(dst[k], v)
        elif isinstance(v, torch.Tensor):
            dst[k].copy_(v)
        else:
            dst[k] = v


def halved(step):
    """The step sees half of its batch's labels."""
    return lambda state, batch: step(state, half_batch(batch))


@pytest.mark.parametrize("cell", tiny.CELLS)
@pytest.mark.parametrize("fault", [unchanged, halved],
                         ids=["state-unchanged", "half-batch"])
def test_a_broken_step_is_not_correct(cell, fault):
    tr, cfg = tiny.cell(cell)
    out = bench_run.run_cell(cell, 2 ** 31 + 21, 1.0, 0, device="cpu",
                             traffic=tr, cfg=cfg, wrap_step=fault)
    assert not out["correct"], out["checks"]
    failed = [n for n, c in out["checks"].items()
              if not c["value"] <= c["limit"]]
    assert failed
