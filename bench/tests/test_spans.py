"""The readers of the program's spans and counters (``harness/spans.py``
and the seven metrics on it), on tiny cells driven on the CPU with
``--trace 1``; and a program without the span table reads None."""
import sys

import pytest

from bench import run as bench_run
from bench.harness import spec
from bench.harness import spans as bench_spans
from bench.tests import tiny

SPAN_METRICS = ("cast_ms_per_step", "head_loss_ms_per_step",
                "blocks_ms_per_step", "grad_accum_ms_per_step",
                "optimizer_ms_per_step", "runner_host_share.tune",
                "probe_epoch_share.tune")


def _listed(cell):
    return {m["name"] for m in spec.load_benchmark()["per_layer"]
            if m["name"] in SPAN_METRICS and cell in m["workloads"]}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for cell in tiny.CELLS:
        tr, cfg = tiny.cell(cell)
        if tr["kind"] == "tune":
            tr.update(steps_per_epoch=1)
        out[cell] = bench_run.run_cell(cell, 2 ** 31 + 41, 2.0, 1,
                                       device="cpu", traffic=tr, cfg=cfg)
    return out


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_each_listed_span_metric_reads_a_value(runs, cell):
    got = runs[cell]["metrics"]
    assert runs[cell]["correct"]
    for name in _listed(cell):
        assert name in got, name
        assert got[name]["value"] >= 0
    assert ("grad_accum_ms_per_step" in _listed(cell)) == cell.endswith(
        "tune-2k")


def test_the_probe_epoch_share_is_within_an_epoch_of_the_token_share(runs):
    out = runs["dsc33b-l5.tune-2k"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    n = bench_spans.counters(out["record"], "tune.epochs.")
    assert sum(n.values()) >= 2
    assert abs(m["probe_epoch_share.tune"] - m["probe_token_share.tune"]) \
        <= 1 / sum(n.values()) + 1e-12
    assert 0 < m["runner_host_share.tune"] < 1


def test_a_program_without_the_table_reads_none(monkeypatch):
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    rec = {"trace": {"steps": 1}, "tune": {"window_s": 1.0}}
    assert bench_spans.table(rec) is None
    for name in SPAN_METRICS:
        assert spec.reader(name)(rec) is None, name
