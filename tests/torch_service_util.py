"""Helpers shared by the port's tuning-service tests
(``tests/test_torch_service.py``, ``test_torch_wire.py``,
``test_torch_dispatch.py``, ``test_torch_elastic_pool.py``): seeded payloads,
bit-exact comparison, and servers and subprocesses on ephemeral ports, each
with a bounded wait."""
import math
import os
import random
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 60.0


def float_bits(x):
    return struct.pack(">d", x)


def assert_same(a, b, path="$"):
    """Structural equality with float *bit* equality (nan == nan) and equal
    types (an int is not a float)."""
    assert type(a) is type(b) or (isinstance(a, (list, tuple)) and
                                  isinstance(b, (list, tuple))), \
        f"{path}: {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, float):
        assert float_bits(a) == float_bits(b), f"{path}: {a!r} != {b!r}"
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


SPECIAL_FLOATS = [math.nan, math.inf, -math.inf, -0.0, 0.0, 5e-324,
                  1.7976931348623157e308, 0.1, 1 / 3, 0.1 + 0.2]


def random_value(rng, depth=0):
    """A seeded nest of the codecs' data model (None, bool, int64, float,
    str, list, str-keyed dict)."""
    kinds = ["none", "bool", "int", "float", "str"]
    if depth < 3:
        kinds += ["list", "dict"] * 2
    kind = rng.choice(kinds)
    if kind == "none":
        return None
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "int":
        return rng.randint(-(1 << 62), 1 << 62)
    if kind == "float":
        return rng.choice([rng.uniform(-1e300, 1e300)] + SPECIAL_FLOATS)
    if kind == "str":
        return "".join(rng.choice("abc λμ 🔥 \n\"\\0") for _ in
                       range(rng.randint(0, 12)))
    if kind == "list":
        return [random_value(rng, depth + 1)
                for _ in range(rng.randint(0, 5))]
    return {f"k{i}-{rng.randint(0, 99)}": random_value(rng, depth + 1)
            for i in range(rng.randint(0, 5))}


def fuzz_payloads(seed=1234, n=200):
    rng = random.Random(seed)
    return [{"op": "fuzz", "v": random_value(rng)} for _ in range(n)] + \
        [{"op": "special", "v": SPECIAL_FLOATS}]


def spawn(args, expect, env=None, extra_path=(), timeout=SPAWN_TIMEOUT_S):
    """Start ``python -m <args>`` from the repo root with ``src`` (and
    `extra_path`) on the path, its output going to a temporary file; wait
    (bounded) for a line containing `expect`; return (process, that line,
    the ``tcp://HOST:PORT`` it names). ``stop`` removes the file."""
    path = [str(ROOT / "src"), *map(str, extra_path)]
    fd, log = tempfile.mkstemp(suffix=".log")
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], stdout=fd, stderr=subprocess.STDOUT,
        cwd=str(ROOT),
        env={**os.environ, **(env or {}), "PYTHONPATH": os.pathsep.join(path)})
    os.close(fd)
    proc.log = log
    deadline = time.monotonic() + timeout
    text = ""
    while time.monotonic() < deadline:
        text = Path(log).read_text()
        for line in text.splitlines():
            if expect in line:
                return proc, line, addr_of(line)
        if proc.poll() is not None:
            break
        time.sleep(0.05)
    stop(proc)
    raise AssertionError(f"{args}: never printed {expect!r}: {text}")


def addr_of(line):
    """The ``tcp://HOST:PORT`` a server's first line names (``... on
    HOST:PORT ...``), or None."""
    if " on " not in line:
        return None
    return "tcp://" + line.split(" on ", 1)[1].split()[0]


def stop(*procs):
    """Terminate each process and wait for it (bounded; then kill)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
        log = getattr(p, "log", None)
        if log is not None and os.path.exists(log):
            os.remove(log)
