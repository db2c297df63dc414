"""The port's spans and counters (``repro_torch.obs.spans``) on the CPU.

Off: ``span()`` is the shared null context and the step's autograd graph
has no marker. Live (``spans.enabled()`` or a torch.profiler session): one
train step of a tiny dense config at 2 microbatches under remat ``block``
records each layer's span forward and backward once a microbatch (the
recompute not counted again), under the ``step`` span; gradients and the
updated state are bit-identical to an untraced step; the table clears when
a profiler session starts and the ``repro.*`` ranges are among its events;
a PipeTune job counts its epochs by phase as its ``TrialRecord``s do.
"""
import collections
import copy
import subprocess
import sys
import time

import pytest
import torch

from repro_torch import weights
from repro_torch.api import Experiment
from repro_torch.core.backends import (BackendCapabilities, EpochResult,
                                       TrialState)
from repro_torch.core.groundtruth import GroundTruth
from repro_torch.core.job import HPTJob, Param, SearchSpace, SystemSpace
from repro_torch.core.profiler import EpochProfile
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.obs import spans
from repro_torch.optim import optimizers

CFG = T.ModelConfig(name="tiny-dense", family="dense", n_layers=2,
                    d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=64,
                    head_dim=8)
SYS = T.SystemConfig(remat="block", microbatches=2, precision="fp32")
PER_STEP = ("grad_accum", "optim.clip", "optim.update", "apply")


@pytest.fixture(autouse=True)
def _off_after():
    yield
    assert not spans.live()


def _batch(seed=1, B=4, S=8):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, CFG.vocab, (B, S), generator=g),
            "labels": torch.randint(0, CFG.vocab, (B, S), generator=g)}


def _state():
    opt = optimizers.adamw(1e-2, weight_decay=0.01)
    state = steps.make_train_state(torch.Generator().manual_seed(0), CFG,
                                   opt, device="cpu")
    return state, steps.make_train_step(CFG, SYS, opt)


def _nodes(loss):
    """The names of every node of ``loss``'s autograd graph, with
    multiplicity."""
    seen, out, todo = set(), collections.Counter(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        out[type(fn).__name__] += 1
        todo += [f for f, _ in fn.next_functions]
    return out


def _loss(params, batch):
    flat = {p: t.detach().requires_grad_()
            for p, t in weights.flatten(params).items()}
    loss, _ = T.loss_fn(weights.unflatten(flat), batch, CFG, SYS)
    return loss, flat


def test_off_span_is_the_shared_null_context():
    a, b = spans.span("step"), spans.span("block")
    assert a is b
    x = torch.ones(3, requires_grad=True)
    with a as sp:
        assert sp.input(x) is x
        assert sp.output(x, {"w": x}) == (x, {"w": x})
        with sp.outside():
            pass
    spans.counter("tune.epochs.probe")
    assert not spans.live()


def test_off_graph_has_no_marker_and_live_adds_only_markers():
    state, _ = _state()
    off = _nodes(_loss(state["params"], _batch())[0])
    with spans.enabled():
        on = _nodes(_loss(state["params"], _batch())[0])
    assert not [n for n in off if n.startswith("Mark")]
    marks = {n: c for n, c in on.items() if n.startswith("Mark")}
    # cast, embed, head_loss: one input and one output marker each; each
    # block two
    assert sum(marks.values()) == 2 * (3 + CFG.n_layers)
    assert on - collections.Counter(marks) == off


def test_one_live_step_records_each_layer_once_a_microbatch():
    state, step = _state()
    with spans.enabled():
        step(state, _batch())
    t = spans.table()
    recs = t["records"]
    count = collections.Counter((r["name"], r["phase"]) for r in recs)
    n_micro = SYS.microbatches
    assert count[("step", "fwd")] == 1
    for name, n in (("block", CFG.n_layers * n_micro), ("cast", n_micro),
                    ("embed", n_micro), ("head_loss", n_micro)):
        assert count[(name, "fwd")] == n, name
        assert count[(name, "bwd")] == n, name
    assert count[("grad_accum", "fwd")] == n_micro   # the sum, the mean
    for name in PER_STEP[1:]:
        assert count[(name, "fwd")] == 1, name
    assert not [k for k in count if k[1] == "bwd" and k[0] in PER_STEP]
    step_id = next(r["id"] for r in recs if r["name"] == "step")
    assert all(r["parent"] == step_id for r in recs if r["name"] != "step")
    tot = t["totals"]
    assert tot["block"]["n"] == 2 * CFG.n_layers * n_micro
    kids = sum(v["device_ms"] for k, v in tot.items() if k != "step")
    assert tot["step"]["self_device_ms"] == pytest.approx(
        tot["step"]["device_ms"] - kids, abs=1e-6)


def test_backward_records_follow_the_backward_order():
    """In one microbatch's backward: the head, then the blocks last layer
    first, then the embedding and the casts, none overlapping."""
    state, step = _state()
    with spans.enabled():
        step(state, _batch())
    bwd = [r for r in spans.table()["records"] if r["phase"] == "bwd"]
    first = bwd[:len(bwd) // SYS.microbatches]
    assert [r["name"] for r in first][:1 + CFG.n_layers] == \
        ["head_loss"] + ["block"] * CFG.n_layers
    assert sorted(r["name"] for r in first[1 + CFG.n_layers:]) == \
        ["cast", "embed"]
    ends = [r["host_ms"] for r in first]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


@pytest.mark.parametrize("what", ["grads", "state"])
def test_live_and_off_are_bit_identical(what):
    state, step = _state()
    batch = _batch()
    if what == "grads":
        out = []
        for live in (False, True):
            with spans.enabled() if live else _nothing():
                loss, flat = _loss(state["params"], batch)
                out.append(torch.autograd.grad(loss, list(flat.values())))
        for a, b in zip(*out):
            assert torch.equal(a, b)
        return
    other = copy.deepcopy(state)
    state, _ = step(state, batch)
    with spans.enabled():
        other, _ = step(other, batch)
    for a, b in zip(weights.flatten(state).values(),
                    weights.flatten(other).values()):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_the_table_clears_when_a_profiler_starts_and_is_live_inside():
    from torch.profiler import ProfilerActivity, profile
    with spans.enabled():
        with spans.span("before"):
            pass
    assert "before" in spans.table()["totals"]
    state, step = _state()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.live()
        step(state, _batch())
    assert not spans.live()
    assert spans.span("after") is spans.span("again")
    t = spans.table()
    assert "before" not in t["totals"] and t["totals"]["step"]["n"] == 1
    names = {e.name for e in prof.events()}
    for r in ("repro.step", "repro.block", "repro.block.bwd",
              "repro.head_loss.bwd", "repro.optim.update", "repro.apply"):
        assert r in names, r
    assert not [n for n in names if n.startswith("bench.")]


def test_spans_nest_and_self_time_excludes_children():
    with spans.enabled():
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("inner"):
                time.sleep(0.002)
        spans.counter("n", 3)
        spans.counter("n")
    t = spans.table()
    outer, inner = t["totals"]["outer"], t["totals"]["inner"]
    assert outer["self_device_ms"] == pytest.approx(
        outer["device_ms"] - inner["device_ms"], abs=1e-9)
    assert inner["self_device_ms"] == inner["device_ms"] >= 2.0
    r = {x["name"]: x for x in t["records"]}
    assert r["inner"]["parent"] == r["outer"]["id"]
    assert r["outer"]["parent"] is None
    assert t["counters"] == {"n": 4}


def test_the_ring_is_bounded_and_the_totals_count_everything(monkeypatch):
    monkeypatch.setattr(spans, "RING", 8)
    with spans.enabled():
        for _ in range(20):
            with spans.span("x"):
                pass
    t = spans.table()
    assert len(t["records"]) == 8 and t["totals"]["x"]["n"] == 20


def test_import_loads_no_torch():
    code = ("import sys, repro_torch.obs.spans as s; "
            "print('torch' in sys.modules, s.live(), "
            "s.span('x') is s.span('y'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.stdout.split() == ["False", "False", "True"], out.stderr


# -- PipeTune's loop -----------------------------------------------------

class _Backend:
    """A backend with no model: an epoch's duration depends on its system
    config, its profile on nothing, so probes differ and later trials hit
    the ground truth."""

    def capabilities(self):
        return BackendCapabilities(deterministic=True)

    def init_trial(self, workload, hparams, seed=0):
        return TrialState(workload=workload, hparams=dict(hparams), cfg=None,
                          params=None, opt_state=None, step=0, epoch=0,
                          data=None, eval_batch={}, seed=seed)

    def run_epoch(self, ts, sys_cfg, collect_profile=True):
        ts.epoch += 1
        dur = 1.0 + 0.1 * sys_cfg["microbatches"] + (
            0.3 if sys_cfg["remat"] == "block" else 0.0)
        return ts, EpochResult(
            duration_s=dur, energy_j=dur, loss=1.0 / ts.epoch,
            accuracy=1.0 - 1.0 / (ts.epoch + 1), sys_config=dict(sys_cfg),
            profile=EpochProfile({"rt.epoch_time": 1.0,
                                  "shape.batch": 8.0}),
            step_times=[dur])


@pytest.mark.parametrize("max_probes", [0, 2, 4])
def test_pipetune_counts_epochs_by_phase_as_its_records(max_probes):
    job = HPTJob(workload="w", space=SearchSpace(
        [Param("lr", "log", 1e-4, 1e-2)]), max_epochs=6, seed=3)
    with spans.enabled():
        res = (Experiment(job).with_tuner("pipetune", max_probes=max_probes)
               .with_backend(_Backend())
               .with_sys_space(SystemSpace(remat=("none", "block"),
                                           microbatches=(1, 2, 4),
                                           precision=("bf16",)))
               .with_groundtruth(GroundTruth())
               .with_scheduler("random", n_trials=4).run())
    t = spans.table()
    recs = list(res.records.values())
    epochs = sum(len(r.epochs) for r in recs)
    probes = sum(r.probe_epochs for r in recs)
    c = t["counters"]
    assert c.get("tune.epochs.profile", 0) == len(recs) == 4
    assert c.get("tune.epochs.probe", 0) == probes
    assert c.get("tune.epochs.locked", 0) == epochs - len(recs) - probes
    if max_probes:
        assert probes > 0 and res.gt_hits > 0
    tot = t["totals"]
    assert tot["tune.trial"]["n"] == 4 and tot["tune.epoch"]["n"] == epochs
    assert tot["tune.init_trial"]["n"] == 4
    assert tot["tune.lookup"]["n"] == 4
    assert tot["tune.schedule"]["n"] >= 5      # a suggest, 4 reports
    by_id = {r["id"]: r for r in t["records"]}
    for r in t["records"]:
        parent = by_id.get(r["parent"], {}).get("name")
        want = {"tune.epoch": "tune.trial", "tune.policy": "tune.trial",
                "tune.init_trial": "tune.trial", "tune.lookup": "tune.policy",
                "tune.store": "tune.policy", "tune.schedule": None,
                "tune.trial": None}[r["name"]]
        assert parent == want, r


def test_interleaved_trials_keep_their_own_parents():
    """Two trials' epoch generators driven in turns, as an event-driven
    executor drives them: each epoch's span is its own trial's child."""
    from repro_torch.core.pipetune import TuneV1
    runner = TuneV1(_Backend())
    with spans.enabled():
        a = runner.trial_epochs("w", "a", {"lr": 1e-3}, 3)
        b = runner.trial_epochs("w", "b", {"lr": 1e-3}, 3)
        for _ in range(3):
            next(a), next(b)
        for g in (a, b):
            with pytest.raises(StopIteration):
                next(g)
    recs = spans.table()["records"]
    trials = {r["id"] for r in recs if r["name"] == "tune.trial"}
    epochs = [r for r in recs if r["name"] == "tune.epoch"]
    assert len(trials) == 2 and len(epochs) == 6
    assert collections.Counter(r["parent"] for r in epochs) == \
        {t: 3 for t in trials}
