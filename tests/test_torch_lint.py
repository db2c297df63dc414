"""Tests for the port's repro_torch.lint static-analysis subsystem: the
reference's tests/test_lint.py, case for case, aimed at src/repro_torch and
lint-baseline.torch.json.

Covers: golden findings per pass against the fixture files, seeded
violations injected into the port's live modules, suppression + baseline
round-trips, JSON schema stability, the CLI, the meta-test that the
committed tree is lint-clean modulo the committed baseline, and parity:
the port's lint renders the same JSON as the reference's over the same
trees.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.lint import (
    Baseline,
    Finding,
    LintConfig,
    Project,
    all_passes,
    default_config,
    render_json,
    run_lint,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src", "repro_torch")
BASELINE = os.path.join(REPO, "lint-baseline.torch.json")
FIXTURES = os.path.join(HERE, "lint_fixtures")


def fixture_source(name):
    with open(os.path.join(FIXTURES, name), "r", encoding="utf-8") as fh:
        return fh.read()


def rules_of(findings):
    out = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


# --------------------------------------------------------------------------
# golden findings per pass


def test_port_determinism_fixture_golden():
    cfg = LintConfig(deterministic_modules=())  # fixture opts in via marker
    project = Project.from_sources(
        {"fixture_determinism.py": fixture_source("fixture_determinism.py")},
        cfg,
    )
    findings, suppressed = run_lint(project, select=["determinism"])
    assert rules_of(findings) == {"DET001": 1, "DET002": 4, "DET003": 1,
                                  "DET004": 2}
    assert suppressed == 1  # the inline-disabled time.time()
    det1 = [f for f in findings if f.rule == "DET001"]
    assert det1[0].symbol == "wall_clock"
    assert "time.time" in det1[0].message


def test_port_wire_fixture_golden():
    cfg = LintConfig(
        clients={"FixtureClient": ("FixtureService",)},
        broadcast_senders={},
        literal_dispatch_servers=(),
        ops_tables={"FixtureService": "_OPS"},
    )
    project = Project.from_sources(
        {"fixture_wire.py": fixture_source("fixture_wire.py")}, cfg
    )
    findings, _ = run_lint(project, select=["wire"])
    counts = rules_of(findings)
    assert counts["WIRE001"] == 1
    assert counts["WIRE003"] == 2          # set value + non-string key
    assert counts["WIRE004"] == 1          # _op_add missing from _OPS
    unsent = {f.message.split("'")[1] for f in findings
              if f.rule == "WIRE002"}
    assert unsent == {"add", "unused"}
    w1 = [f for f in findings if f.rule == "WIRE001"][0]
    assert "missing_op" in w1.message and w1.severity == "error"


def test_port_locks_fixture_golden():
    cfg = LintConfig(
        attr_types={
            ("FixtureBusA", "peer"): ("FixtureBusB",),
            ("FixtureBusB", "pool"): ("FixtureBusA",),
        }
    )
    project = Project.from_sources(
        {"fixture_locks.py": fixture_source("fixture_locks.py")}, cfg
    )
    findings, _ = run_lint(project, select=["locks"])
    counts = rules_of(findings)
    assert counts == {"LOCK001": 1, "LOCK002": 1}
    lock1 = [f for f in findings if f.rule == "LOCK001"][0]
    assert lock1.symbol == "FixturePool.close"
    assert "workers" in lock1.message
    # _op_retire pops workers too, but only under handle's dynamic
    # dispatch while locked — must NOT be flagged
    assert not any(f.symbol.endswith("_op_retire") for f in findings)


def test_port_events_fixture_golden():
    cfg = LintConfig(
        event_module="fixture_events.py",
        kind_check_paths=("fixture_events_use.py",),
        kind_dispatchers={"dispatch": ()},
    )
    project = Project.from_sources(
        {
            "fixture_events.py": fixture_source("fixture_events.py"),
            "fixture_events_use.py": fixture_source("fixture_events_use.py"),
        },
        cfg,
    )
    findings, _ = run_lint(project, select=["events"])
    counts = rules_of(findings)
    assert counts == {"EVT001": 1, "EVT002": 2, "EVT003": 1, "EVT004": 1,
                      "EVT005": 1}
    evt3 = [f for f in findings if f.rule == "EVT003"][0]
    assert "fixture_startd" in evt3.message
    evt5 = [f for f in findings if f.rule == "EVT005"][0]
    assert "fixture_orphan" in evt5.message


def test_port_serve_fixture_golden():
    cfg = LintConfig(
        serve_scopes={
            "FixtureServer": ("_on_readable", "_on_writable", "_run_handler")
        },
        serve_paths=("fixture",),
    )
    project = Project.from_sources(
        {"fixture_serve.py": fixture_source("fixture_serve.py")}, cfg
    )
    findings, _ = run_lint(project, select=["serve", "capability"])
    counts = rules_of(findings)
    assert counts == {"EXC001": 2, "EXC002": 1, "CAP001": 1}
    descs = {f.message.split(" in serve scope")[0] for f in findings
             if f.rule == "EXC001"}
    assert descs == {"socket op .recv()", "codec .encode()"}


# --------------------------------------------------------------------------
# seeded violations in live modules


def _live_sources():
    project = Project.from_dir(SRC, default_config())
    return {path: mod.source for path, mod in project.modules.items()}


def test_port_seeded_wall_clock_in_engine():
    sources = _live_sources()
    assert "cluster/engine.py" in sources
    clean = Project.from_sources(sources, default_config())
    before, _ = run_lint(clean, select=["determinism"])
    assert not [f for f in before if f.path == "cluster/engine.py"]

    sources["cluster/engine.py"] += (
        "\n\ndef _seeded_violation():\n    return time.time()\n"
    )
    mutated = Project.from_sources(sources, default_config())
    after, _ = run_lint(mutated, select=["determinism"])
    hits = [f for f in after if f.path == "cluster/engine.py"]
    assert len(hits) == 1 and hits[0].rule == "DET001"
    assert hits[0].symbol == "_seeded_violation"


def test_port_seeded_op_removed_from_ops_table():
    sources = _live_sources()
    src = sources["service/service.py"]
    assert '"add"' in src.split("\n", 60)[0] or '"add"' in src
    sources["service/service.py"] = src.replace(
        '"add",', "", 1
    )  # drop "add" from the module-level _OPS gate
    mutated = Project.from_sources(sources, default_config())
    findings, _ = run_lint(mutated, select=["wire"])
    w4 = [f for f in findings if f.rule == "WIRE004"]
    assert any("_op_add" in f.message for f in w4), w4


def test_port_seeded_kernel_db_removed_from_ops_table():
    sources = _live_sources()
    src = sources["service/service.py"]
    assert '"kernel_db"' in src
    sources["service/service.py"] = src.replace(
        ', "kernel_db"', "", 1
    )  # drop the find-db op from the module-level _OPS gate
    mutated = Project.from_sources(sources, default_config())
    findings, _ = run_lint(mutated, select=["wire"])
    w4 = [f for f in findings if f.rule == "WIRE004"]
    assert any("_op_kernel_db" in f.message for f in w4), w4


def test_port_seeded_kernel_db_client_op_typo():
    # the StoreClient kernel helpers are plain dict-literal sends, so the
    # existing clients mapping cross-checks them against the service _OPS
    # gate with no lint-config edits: a typo'd op name is a static error
    sources = _live_sources()
    src = sources["service/transport.py"]
    assert src.count('"op": "kernel_db"') == 3
    sources["service/transport.py"] = src.replace(
        '"op": "kernel_db"', '"op": "kernel_bd"', 1)
    mutated = Project.from_sources(sources, default_config())
    findings, _ = run_lint(mutated, select=["wire"])
    w1 = [f for f in findings if f.rule == "WIRE001"
          and "kernel_bd" in f.message]
    assert len(w1) == 1, [f.message for f in findings]


def test_port_seeded_unlocked_write_in_worker_service():
    sources = _live_sources()
    sources["service/worker.py"] += (
        "\n\nclass _SeededRace:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.state = []\n"
        "    def locked_add(self, x):\n"
        "        with self._lock:\n"
        "            self.state.append(x)\n"
        "    def wipe(self):\n"
        "        self.state = []\n"
    )
    mutated = Project.from_sources(sources, default_config())
    findings, _ = run_lint(mutated, select=["locks"])
    hits = [f for f in findings if f.symbol == "_SeededRace.wipe"]
    assert len(hits) == 1 and hits[0].rule == "LOCK001"


# --------------------------------------------------------------------------
# suppression + baseline


def test_port_inline_suppression_modes():
    cfg = LintConfig(deterministic_modules=("mod.py",))
    body = (
        "import time\n"
        "def a():\n"
        "    return time.time()  # lint: disable=DET001\n"
        "def b():\n"
        "    # lint: disable-next=determinism\n"
        "    return time.time()\n"
        "def c():\n"
        "    return time.time()\n"
    )
    findings, suppressed = run_lint(
        Project.from_sources({"mod.py": body}, cfg), select=["determinism"]
    )
    assert suppressed == 2
    assert [f.symbol for f in findings] == ["c"]

    filewide = "# lint: disable-file=all\n" + body
    findings, suppressed = run_lint(
        Project.from_sources({"mod.py": filewide}, cfg),
        select=["determinism"],
    )
    assert findings == [] and suppressed == 3


def test_port_baseline_roundtrip(tmp_path):
    f1 = Finding(path="a.py", line=10, col=0, rule="DET001",
                 severity="error", message="m1", symbol="A.f")
    f2 = Finding(path="b.py", line=3, col=4, rule="LOCK001",
                 severity="error", message="m2", symbol="B.g")
    path = str(tmp_path / "baseline.json")
    Baseline.from_findings([f1, f2]).save(path)
    loaded = Baseline.load(path)
    new, old = loaded.split([f1, f2])
    assert new == [] and len(old) == 2

    # line drift does not invalidate entries; message drift does
    drifted = Finding(path="a.py", line=99, col=7, rule="DET001",
                      severity="error", message="m1", symbol="A.f")
    changed = Finding(path="a.py", line=10, col=0, rule="DET001",
                      severity="error", message="other", symbol="A.f")
    new, old = loaded.split([drifted, changed])
    assert old == [drifted] and new == [changed]


def test_port_baseline_rewrite_preserves_reasons(tmp_path):
    f1 = Finding(path="a.py", line=1, col=0, rule="DET001",
                 severity="error", message="m1", symbol="A.f")
    path = str(tmp_path / "baseline.json")
    first = Baseline.from_findings([f1])
    first.entries[0]["reason"] = "because physics"
    first.save(path)
    rewritten = Baseline.from_findings([f1], previous=Baseline.load(path))
    assert rewritten.entries[0]["reason"] == "because physics"


# --------------------------------------------------------------------------
# JSON schema


def test_port_json_report_schema_stable():
    cfg = LintConfig(deterministic_modules=("mod.py",))
    findings, suppressed = run_lint(
        Project.from_sources(
            {"mod.py": "import time\nT = time.time()\n"}, cfg
        ),
        select=["determinism"],
    )
    doc = json.loads(
        render_json(findings, baselined=[], suppressed=suppressed,
                    passes=["determinism"])
    )
    assert set(doc) == {"schema", "passes", "summary", "findings",
                        "baselined"}
    assert doc["schema"] == "repro.lint/1"
    assert set(doc["summary"]) == {"findings", "errors", "warnings",
                                   "baselined", "suppressed"}
    assert doc["summary"]["findings"] == 1
    (rec,) = doc["findings"]
    assert set(rec) == {"rule", "severity", "path", "line", "col", "symbol",
                        "message", "pass"}


# --------------------------------------------------------------------------
# meta: the committed tree is clean modulo the committed baseline


def test_port_live_tree_clean_modulo_baseline():
    project = Project.from_dir(SRC, default_config())
    findings, _ = run_lint(project)
    baseline = Baseline.load(BASELINE)
    new, _ = baseline.split(findings)
    assert new == [], "un-baselined findings:\n" + "\n".join(
        "%s:%d %s %s" % (f.path, f.line, f.rule, f.message) for f in new
    )


def test_port_all_five_passes_registered():
    names = {cls.name for cls in all_passes()}
    assert {"determinism", "wire", "locks", "events", "serve",
            "capability"} <= names


# --------------------------------------------------------------------------
# CLI


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120,
    )


def test_port_cli_clean_tree_exits_zero():
    res = _run_cli("--fail-on-findings", "--baseline", BASELINE)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s)" in res.stdout


def test_port_cli_json_report(tmp_path):
    out = str(tmp_path / "report.json")
    res = _run_cli("--json", "--json-out", out)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout)
    assert doc["schema"] == "repro.lint/1"
    with open(out) as fh:
        assert json.load(fh) == doc


def test_port_cli_fails_on_findings():
    res = _run_cli(FIXTURES, "--no-baseline", "--select",
                   "capability")
    assert res.returncode == 1
    assert "CAP001" in res.stdout


# --------------------------------------------------------------------------
# parity with the reference's lint


def _render(lint, root, cfg):
    project = lint.Project.from_dir(root, cfg)
    findings, suppressed = lint.run_lint(project)
    return lint.render_json(findings, baselined=[], suppressed=suppressed,
                            passes=[c.name for c in lint.all_passes()])


@pytest.mark.parametrize("tree", ["fixtures", "port"])
def test_port_json_equals_the_reference_lint(tree):
    """The port's lint and the reference's render the same report over the
    fixtures (at the default config) and over src/repro_torch."""
    import repro.lint as ref
    import repro_torch.lint as port
    root = FIXTURES if tree == "fixtures" else SRC
    got = _render(port, root, port.default_config())
    want = _render(ref, root, ref.default_config())
    assert json.loads(got)["findings"]
    assert got == want


def test_port_baseline_holds_the_references_two_findings():
    """lint-baseline.torch.json baselines the port's two findings, the
    reference's two in the port's tree, each with a reason."""
    project = Project.from_dir(SRC, default_config())
    findings, _ = run_lint(project)
    baseline = Baseline.load(BASELINE)
    assert sorted((f.rule, f.symbol) for f in findings) == [
        ("LOCK001", "GroundTruthService._replay"),
        ("WIRE002", "GroundTruthService")]
    assert all(e["reason"] for e in baseline.entries)
    assert len(baseline.entries) == 2
