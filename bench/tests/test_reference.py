"""The plain reference against the program at reduced sizes on the CPU:
the loss and the updated parameters after a step, and the
whole check of a run."""
import pytest
import torch

from bench import run as bench_run
from bench.harness import check, program, train, weights
from bench.tests import tiny


def test_one_step_matches():
    cfg, seed, dev = tiny.DENSE, 2 ** 31 + 11, torch.device("cpu")
    tr = dict(tiny.cell("dsc33b-l5.train-16k")[0], lr=1e-2, warmup_steps=0)
    h = train.hyper(tr)
    batch = next(weights.batches(cfg, seed, dev, 2, 64))
    opt = program.optimizer(h["lr"], h["warmup"], h["total"],
                            h["weight_decay"])
    flat = weights.init_params(cfg, seed, dev)
    state = program.train_state(weights.unflatten(flat), opt)
    step = program.train_step(program.model_config(cfg),
                              program.system_config("none", 1, "fp32"), opt)
    state, m = step(state, batch)
    ref_flat = weights.init_params(cfg, seed, dev)
    ref = check.reference_module(cfg).train(ref_flat, [batch], cfg, h)
    assert abs(float(m["loss"]) - ref["losses"][0]) <= 1e-5 * ref[
        "losses"][0]
    # adamw's first update of an element is g / (|g| + eps): where |g| is
    # near eps (1e-8) rounding moves it by a few hundredths of lr; every
    # other element agrees to rounding
    for k in flat:
        diff = (flat[k] - ref_flat[k]).abs()
        assert float(diff.max()) <= 0.1 * h["lr"], k
        off = (diff > 1e-6 + 1e-5 * ref_flat[k].abs()).float().mean()
        assert float(off) <= 1e-3, k
    moved = sum(float((ref_flat[k] - weights.init_params(cfg, seed, dev)[k])
                      .abs().max()) for k in flat)
    assert moved > 0


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_sound_run_is_correct(cell):
    tr, cfg = tiny.cell(cell)
    out = bench_run.run_cell(cell, 2 ** 31 + 3, 3.0, 0, device="cpu",
                             traffic=tr, cfg=cfg)
    assert out["correct"], out["checks"]
    for c in out["checks"].values():
        assert c["value"] < 1e-4
    assert out["attempted"] > 0 and out["failed"] == 0
