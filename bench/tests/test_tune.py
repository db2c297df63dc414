"""The tune cell's check: its own readings stay out of the window."""
from bench import run as bench_run
from bench.harness import trace
from bench.tests import tiny

CELL = "dsc33b-l5.tune-2k"


def test_the_checks_readings_are_paused_out_of_the_window():
    tr, cfg = tiny.cell(CELL)
    out = bench_run.run_cell(CELL, 2 ** 31 + 31, 3.0, 0, device="cpu",
                             traffic=tr, cfg=cfg)
    rec = out["record"]
    assert rec["paused_s"] > 0
    assert out["correct"], out["checks"]


def test_idle_gaps_skip_the_checks_own_range():
    spans = [(0, 10), (20, 30), (100, 110)]
    none = trace.Ranges([])
    check = trace.Ranges([(40, 90, "bench.check")])
    got = trace._gaps(spans, none, none, check)
    assert [round(g[1] * 1e9) for g in got] == [10]
    assert len(trace._gaps(spans, none, none, none)) == 2
