"""The harness finds configurations, traffic and metrics by name, and a
new one is picked up from new files alone."""
import json
import shutil

import pytest

from bench.harness import spec


def test_every_name_in_the_benchmark_has_its_files():
    bench = spec.load_benchmark()
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).exists()
        assert spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        tr = spec.traffic(w["name"])
        assert spec.driver(tr["kind"]).run
        assert tr["limits"] and set(tr["limits"]) <= {
            "loss_gap", "grad_gap", "change_gap"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_each_cell_reports_its_metrics(cell, traced):
    bench = spec.load_benchmark()
    names = {m["name"] for m in spec.metrics_of(bench, cell, traced)}
    if traced:
        assert {"mfu", "idle_share", "b1_roofline"} <= names
        assert all(m["moves"] == "train_tokens_per_s"
                   for m in spec.metrics_of(bench, cell, True))
    else:
        assert {"setup_s", "train_tokens_per_s"} <= names


def test_a_new_cell_config_and_metric_need_no_edit(tmp_path):
    """A copy of the benchmark plus new files only: a configuration, a
    traffic file and a metric reader, and their BENCHMARK.json entries."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "bench")
    bench = spec.load_benchmark()
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "bench").rglob("*") if p.is_file()}
    cfg = json.loads((root / "bench/configs/dsc33b-l5.json").read_text())
    cfg.update(name="dsc33b-l2", num_hidden_layers=2)
    (root / "bench/configs/dsc33b-l2.json").write_text(json.dumps(cfg))
    tr = spec.traffic("dsc33b-l5.train-16k")
    tr.update(seq=8192, batch=2)
    (root / "bench/workloads/dsc33b-l2.train-8k.json").write_text(
        json.dumps(tr))
    (root / "bench/metrics/steps_in_window.py").write_text(
        "def read(rec):\n    return rec['steps']\n")
    bench["configs"].append({"name": "dsc33b-l2",
                             "file": "bench/configs/dsc33b-l2.json"})
    bench["workloads"].append({"name": "dsc33b-l2.train-8k",
                               "config": "dsc33b-l2", "chips": 1})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "moves": "train_tokens_per_s",
                               "workloads": ["dsc33b-l2.train-8k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    got = spec.load_benchmark(root)
    entry = spec.workload_entry(got, "dsc33b-l2.train-8k")
    assert spec.config(entry["config"], root / "bench")[
        "num_hidden_layers"] == 2
    assert spec.traffic("dsc33b-l2.train-8k", root / "bench")["seq"] == 8192
    entries = spec.metrics_of(got, "dsc33b-l2.train-8k", True)
    assert [m["name"] for m in entries] == ["steps_in_window"]
    assert spec.read_metrics(entries, {"steps": 7}, root / "bench") == {
        "steps_in_window": {"value": 7, "unit": "steps"}}
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "bench").rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())


def test_a_missing_name_is_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.workload_entry(spec.load_benchmark(), "no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")
    with pytest.raises(spec.SpecError):
        spec.load_benchmark(tmp_path)
    with pytest.raises(spec.SpecError):
        spec.driver("no_such_kind")


def test_a_reader_that_finds_nothing_returns_nothing():
    rec = {"trace": None, "tune": None, "energy_j": None, "tokens": 10,
           "window_s": 1.0, "peak_bytes": 0, "setup_s": 3.0, "steps": 1}
    bench = spec.load_benchmark()
    got = spec.read_metrics(bench["per_layer"], rec)
    assert got == {}
    e2e = spec.read_metrics(bench["end_to_end"], rec)
    assert set(e2e) == {"train_tokens_per_s", "setup_s"}
