"""The port's ``MetricsStore`` (``repro_torch.core.store``) against the
reference's ``repro.core.store``, on the CPU.

A store written by either package reads back in the other, row for row
(tags, fields and timestamps equal). The rest mirrors the reference's
tests of its flushing rules (tests/test_obs.py, tests/test_service.py): the
64-record buffer, flushing on ``close()``, in the context manager and in the
finalizer, a drain-before-write that never duplicates a row, and the query
filters by tags and time range.
"""
import gc
import json
import os

import pytest

from repro.core import store as jstore
from repro_torch.core import store as tstore

ROWS = [("epochs", {"loss": 0.5 + i, "acc": i / 10}, {"trial": f"t{i % 3}"},
         float(i)) for i in range(70)] + \
    [("events", {"reason": "heartbeat"}, {"kind": "worker_retired"}, 3.5)]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _write(mod, root):
    with mod.MetricsStore(str(root)) as ms:
        for measurement, fields, tags, ts in ROWS:
            ms.write(measurement, fields, tags=tags, ts=ts)


@pytest.mark.parametrize("writer,reader", [(tstore, jstore), (jstore, tstore)],
                         ids=["port-to-reference", "reference-to-port"])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                         reader):
    _write(writer, tmp_path / "a")
    _write(reader, tmp_path / "b")
    for name in ("epochs.jsonl", "events.jsonl"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
    ms = reader.MetricsStore(str(tmp_path / "a"))
    got = ms.query("epochs", tags={"trial": "t1"}, t0=10.0, t1=40.0)
    assert [r["ts"] for r in got] == [float(i) for i in range(10, 41)
                                      if i % 3 == 1]
    assert got[0] == {"ts": 10.0, "tags": {"trial": "t1"},
                      "fields": {"loss": 10.5, "acc": 1.0}}
    assert ms.query("events", tags={"kind": "worker_retired"})[0][
        "fields"] == {"reason": "heartbeat"}
    ms.close()


def test_buffer_flushes_at_64_records(tmp_path):
    ms = tstore.MetricsStore(str(tmp_path))
    path = tmp_path / "m.jsonl"
    for i in range(63):
        ms.write("m", {"i": i}, ts=float(i))
    assert not path.exists()                      # still buffered
    ms.write("m", {"i": 63}, ts=63.0)
    assert len(_rows(path)) == 64                 # the 64th flushes
    ms.write("m", {"i": 64}, ts=64.0)
    assert len(_rows(path)) == 64
    ms.close()
    assert [r["fields"]["i"] for r in _rows(path)] == list(range(65))


def test_metrics_store_context_manager_flushes_partial_batch(tmp_path):
    with tstore.MetricsStore(str(tmp_path)) as ms:
        for i in range(10):                       # < the 64-record buffer
            ms.write("epochs", {"i": i}, ts=float(i))
    assert len(_rows(tmp_path / "epochs.jsonl")) == 10


def test_metrics_store_finalizer_flushes_on_gc(tmp_path):
    ms = tstore.MetricsStore(str(tmp_path))
    ms.write("m", {"x": 1}, ts=0.0)
    del ms                                        # finalizer must flush
    gc.collect()
    assert len(_rows(tmp_path / "m.jsonl")) == 1


def test_metrics_store_query_still_sees_buffered_records(tmp_path):
    ms = tstore.MetricsStore(str(tmp_path))
    ms.write("m", {"x": 1}, tags={"k": "v"}, ts=1.0)
    assert len(ms.query("m", tags={"k": "v"})) == 1
    assert ms.query("m", tags={"k": "w"}) == []
    assert ms.query("m", t0=2.0) == [] and ms.query("absent") == []
    ms.close()


def test_metrics_store_flush_is_idempotent(tmp_path):
    root = str(tmp_path / "ms")
    ms = tstore.MetricsStore(root)
    ms.write("m", {"v": 1})
    # overlapping triggers: explicit close, a second close, and the
    # GC/atexit finalizer path — one row, no matter how many fire
    ms.flush()
    ms.close()
    ms.close()
    tstore._flush_buffers(ms.root, ms._buffers, ms._lock)
    assert len(_rows(os.path.join(root, "m.jsonl"))) == 1


def test_metrics_store_partial_write_failure_never_duplicates(tmp_path):
    """A flush that dies mid-batch (record 2 unserializable) must not leave
    record 1 in the buffer to be written again by the next flush."""
    root = str(tmp_path / "ms")
    ms = tstore.MetricsStore(root)
    ms.write("m", {"v": 1})
    ms.write("m", {"v": object()})                # json.dumps will raise
    with pytest.raises(TypeError):
        ms.flush()
    ms.close()                                    # close re-triggers flush
    rows = _rows(os.path.join(root, "m.jsonl"))
    assert [r["fields"] for r in rows] == [{"v": 1}]    # once, not twice
