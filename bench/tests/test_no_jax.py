"""Nothing the benchmark runs imports JAX, flax or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` is not
``repro``), and the reference imports nothing of the program."""
import ast
import subprocess
import sys

from bench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_importing_every_module_loads_no_jax():
    code = f"""
import sys
sys.path[:0] = [{str(spec.ROOT / 'src')!r}, {str(spec.ROOT)!r}]
import bench.run, bench.control
from bench.harness import spec, train, tune, check, trace, nvml, program
from bench.references import transformer
bench = spec.load_benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
for w in bench["workloads"]:
    spec.driver(spec.traffic(w["name"])["kind"])
    spec.config(w["config"])
program.tuning_api()
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "torch" in loaded
    assert not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_imports_jax_and_the_reference_is_plain():
    for path in spec.BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
    for path in (spec.BENCH / "references").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"torch", "math", "__future__"}, (path, tops)


def test_the_run_refuses_a_loaded_jax_name(monkeypatch):
    from bench import run
    monkeypatch.setitem(sys.modules, "repro", object())
    assert run.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro")
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert run.forbidden_modules() == []
