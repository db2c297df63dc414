"""Find a cell's files by the names in ``BENCHMARK.json``.

* ``bench/workloads/<cell>.json``: the cell's traffic, with its ``kind``
  (a driver module ``bench/harness/<kind>.py``), its parameters and the
  limits of its correctness check;
* ``bench/configs/<config>.json``: the model's sizes as run;
* ``bench/metrics/<metric>.py``: one reader a metric, ``read(rec)`` of the
  run's record, returning a number or None where it finds nothing.

A new cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class SpecError(RuntimeError):
    """A name in ``BENCHMARK.json`` with no file, or a malformed file."""


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.exists():
        raise SpecError(f"{path} is missing")
    return json.loads(path.read_text())


def workload_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json; known: "
                    f"{[w['name'] for w in bench['workloads']]}")


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    return _json(bench_dir / "workloads" / f"{name}.json")


def config(name: str, bench_dir: Path = BENCH) -> dict:
    return _json(bench_dir / "configs" / f"{name}.json")


def driver(kind: str):
    """The module that runs a workload of ``kind``."""
    name = f"bench.harness.{kind}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise           # the driver is there; something it imports is not
        raise SpecError(f"no driver for workload kind {kind!r}") from e


def reader(metric: str, bench_dir: Path = BENCH):
    """``read`` of ``bench/metrics/<metric>.py``."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.exists():
        raise SpecError(f"no reader {path} for metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics untraced,
    its per-layer metrics traced (those that list it, or, without a
    ``workloads`` key, those whose end-to-end metric it reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def read_metrics(entries: list, rec: dict, bench_dir: Path = BENCH) -> dict:
    """{name: {"value", "unit"}} of every entry whose reader finds a
    value."""
    out = {}
    for m in entries:
        v = reader(m["name"], bench_dir)(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
