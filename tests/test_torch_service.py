"""The port's tuning service (``repro_torch.service``: codecs, the
ground-truth service and its journal, ``StoreClient``, the launcher's store
flags and the kernel tuner's store sources) against the reference's
``repro.service``.

- Codec bytes equal the reference's for a seeded fuzz and the special
  floats, under json, tlv and msgpack (skipped only where msgpack is not
  installed); ``codec.plain`` puts numpy scalars and 0-d tensors in the
  data model.
- ``GroundTruthService`` gives the reference's replies, versions included,
  for one seeded request sequence; its journal lines are the reference's
  bytes, and each package replays the other's journal to an equal store,
  under the torn-tail and corruption rules.
- The launcher over ``--store tcp://`` (a port and a reference store
  server) prints what ``--store inproc`` and the reference's launcher
  print, energy apart.
- The kernel tuner's ``--store``, ``--journal`` and ``import`` on the CPU.
"""
import json
import threading

import numpy as np
import pytest
import torch

import repro.launch.tune as jtune_launch
import repro.service as jservice
import repro.service.codec as jcodec
import repro_torch.core.groundtruth as tgt
import repro_torch.service as tservice
import repro_torch.service.codec as tcodec
from repro_torch.kernels import findb
from repro_torch.kernels import tune as ktune
from repro_torch.launch import tune as tune_launch
from torch_service_util import SPECIAL_FLOATS, assert_same, fuzz_payloads

PKGS = {"reference": jservice, "port": tservice}


# ------------------------------------------------------------------ codecs

@pytest.mark.parametrize("name", ["json", "tlv", "msgpack"])
def test_codec_bytes_equal_the_reference(name):
    if name not in tcodec.available_codecs():
        pytest.skip("msgpack is not installed")
    assert tcodec.available_codecs() == jcodec.available_codecs()
    ours, theirs = tcodec.get_codec(name), jcodec.get_codec(name)
    for i, p in enumerate(fuzz_payloads()):
        data = ours.encode(p)
        assert data == theirs.encode(p), f"payload #{i}"
        assert_same(ours.decode(data), theirs.decode(data), f"#{i}")
        assert_same(ours.decode(data), p if name != "json" else
                    json.loads(json.dumps(p)), f"#{i}")
    special = ours.decode(ours.encode({"v": SPECIAL_FLOATS}))["v"]
    assert_same(special, SPECIAL_FLOATS)


def test_codec_names_and_errors_are_the_reference():
    assert tcodec.get_codec("binary").name == jcodec.get_codec("binary").name
    assert tcodec.best_binary_codec().name == jcodec.best_binary_codec().name
    for bad in (b"\xc1", b"\xdb\x00\x00\x00\x09ab", b"\xc0\x00"):
        with pytest.raises(tcodec.CodecError) as ours:
            tcodec.get_codec("tlv").decode(bad)
        with pytest.raises(jcodec.CodecError) as theirs:
            jcodec.get_codec("tlv").decode(bad)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(tcodec.CodecError, match="unknown wire codec"):
        tcodec.get_codec("protobuf")


@pytest.mark.parametrize("name", ["json", "tlv"])
def test_plain_puts_numpy_and_tensor_scalars_in_the_data_model(name):
    """A record's hparams and sys config may hold numpy scalars or a 0-d
    tensor: JSON refuses an np.int64 and an np.float32, TLV would send an
    np.float64 as a float but refuses the rest. ``plain`` turns each into
    the Python number it holds, so the bytes are those of Python numbers
    and the values survive bit for bit."""
    raw = {"lr": np.float32(0.1), "batch_size": np.int64(64),
           "dropout": np.float64(0.25), "loss": torch.tensor(2.5),
           "on": np.bool_(True), "steps": [np.float32(1.5), 3]}
    want = {"lr": float(np.float32(0.1)), "batch_size": 64, "dropout": 0.25,
            "loss": 2.5, "on": True, "steps": [1.5, 3]}
    codec = tcodec.get_codec(name)
    with pytest.raises(tcodec.CodecError):
        codec.encode(raw)
    got = tcodec.plain(raw)
    assert_same(got, want)
    assert codec.encode(got) == jcodec.get_codec(name).encode(want)


# ------------------------------------------------------ service protocol

def _profile(rng, block=0, level=10.0, jitter=0.05):
    base = np.zeros(58)
    base[block * 5:(block + 1) * 5] = level
    return (base + rng.randn(58) * jitter).tolist()


def _requests(seed=0):
    """One seeded sequence of every op but obs_trace, with bad requests."""
    rng = np.random.RandomState(seed)
    reqs = [{"op": "version"}, {"op": "snapshot"}]
    for i in range(6):
        reqs.append({"op": "add", "profile": _profile(rng, block=i % 2),
                     "workload": f"wl{i % 2}",
                     "sys_config": {"remat": ["none", "block"][i % 2],
                                    "microbatches": 1 + i % 3},
                     "objective": float(rng.rand()),
                     "refit": bool(i % 3)})
        reqs.append({"op": "lookup", "profile": _profile(rng, block=i % 2)})
    reqs += [{"op": "refit"}, {"op": "snapshot"},
             {"op": "lookup", "profile": _profile(rng, block=5, level=40.0)},
             {"op": "kernel_db", "puts": [
                 {"kernel": "rglru", "shape": "B=1,R=128,S=512",
                  "hardware": "cuda/NVIDIA H100 80GB HBM3",
                  "config": {"chunk": 128, "r_block": 64},
                  "objective": 0.25},
                 {"kernel": "mlstm", "shape": "B=1,D=32,H=2,S=256",
                  "config": {"chunk": 64}}],
              "queries": [{"kernel": "rglru", "shape": "B=1,R=128,S=512",
                           "hardware": "cuda/NVIDIA H100 80GB HBM3"},
                          {"kernel": "rglru", "shape": "B=1,R=128,S=512"}],
              "export": True},
             {"op": "batch", "requests": [
                 {"op": "add", "profile": _profile(rng), "workload": "wl0",
                  "sys_config": {"remat": "none"}, "objective": 0.5,
                  "refit": False},
                 {"op": "nope"}, {"op": "batch", "requests": []},
                 {"op": "refit"},
                 {"op": "kernel_db", "puts": [
                     {"kernel": "mlstm", "shape": "B=2", "config":
                      {"chunk": 32}, "objective": 1.0}]}]},
             {"op": "batch"}, {"op": "add", "profile": [1.0]},
             {"op": "drop_all"}, {"op": "kernel_db", "puts": [{}]},
             {"op": "snapshot"}, {"op": "version"}]
    return reqs


def _replies(pkg, path=None, reqs=None):
    svc = PKGS[pkg].GroundTruthService(path=path)
    try:
        return [svc.handle(json.loads(json.dumps(r)))
                for r in (reqs if reqs is not None else _requests())]
    finally:
        svc.close()


def test_service_replies_equal_the_reference():
    ours, theirs = _replies("port"), _replies("reference")
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert_same(a, b, f"reply {i}")
    assert any(r.get("config") for r in ours if "score" in r), \
        "the sequence never hit the store"
    assert ours[-1]["version"] > 0 and not ours[-3]["ok"]


def test_obs_trace_answers_naming_item_13_and_reads_as_legacy():
    """The distributed-tracing hello is item 13: the service answers an
    error naming it, and the reference's client reads that as a legacy
    peer (untraced, no error)."""
    from repro.obs.forward import propagate_trace
    svc = tservice.GroundTruthService()
    resp = svc.handle({"op": "obs_trace", "trace": "t1"})
    assert not resp["ok"] and "item 13 (Observability and chaos)" in \
        resp["error"]
    server = tservice.serve(svc, port=0, background=True)
    try:
        transport = jservice.SocketTransport(*server.server_address[:2])
        assert propagate_trace(transport, "t1") is False
        assert transport.request({"op": "version"})["ok"]
        transport.close()
        client = tservice.StoreClient(tservice.InprocTransport(svc))
        with pytest.raises(NotImplementedError, match="item 13"):
            client.enable_trace("t1")
    finally:
        server.shutdown()


# ----------------------------------------------------------------- journal

def test_journal_lines_are_the_reference_bytes(tmp_path):
    paths = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in PKGS}
    for pkg, path in paths.items():
        _replies(pkg, path)
    ours = open(paths["port"], "rb").read()
    assert ours == open(paths["reference"], "rb").read()
    assert ours.count(b"\n") == 10      # 7 adds, 3 kernel puts


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_each_package_replays_the_others_journal(tmp_path, writer, reader):
    path = str(tmp_path / "gt.jsonl")
    _replies(writer, path)
    probe = [{"op": "snapshot"}, {"op": "kernel_db", "export": True},
             {"op": "lookup", "profile": _profile(np.random.RandomState(5))}]
    replayed = _replies(reader, path, probe)
    fresh = _replies(writer, str(tmp_path / "again.jsonl"))
    # a service replaying a journal holds the store a live one built, with
    # the lookups' hit counters starting again from zero
    live = PKGS[writer].GroundTruthService(path=str(tmp_path / "again.jsonl"))
    try:
        want = [live.handle(r) for r in probe]
    finally:
        live.close()
    for i, (a, b) in enumerate(zip(replayed, want)):
        assert_same(a, b, f"probe {i}")
    assert fresh[-1]["ok"]


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_torn_tail_is_dropped_and_corruption_raises_alike(tmp_path, writer,
                                                          reader):
    path = tmp_path / "gt.jsonl"
    _replies(writer, str(path))
    lines = path.read_text().splitlines(keepends=True)
    torn = tmp_path / "torn.jsonl"
    torn.write_text("".join(lines) + lines[0][:25])     # a crash mid-append
    svc = PKGS[reader].GroundTruthService(path=str(torn))
    n = len(svc.store.entries)
    svc.close()
    assert n == 7 and torn.read_text() == "".join(lines)   # repaired
    bad = tmp_path / "bad.jsonl"
    bad.write_text("".join(lines[:3]) + "{not json\n" + "".join(lines[3:]))
    errors = {"reference": __import__("repro.core.groundtruth",
                                      fromlist=["x"]).GroundTruthError,
              "port": tgt.GroundTruthError}
    with pytest.raises(errors[reader], match="record 4") as ours:
        PKGS[reader].GroundTruthService(path=str(bad))
    with pytest.raises(errors[writer]) as theirs:
        PKGS[writer].GroundTruthService(path=str(bad))
    assert str(ours.value) == str(theirs.value)
    assert bad.read_text().count("\n") == len(lines) + 1   # not truncated


def test_batch_makes_one_journal_flush(tmp_path):
    class Counter:
        def __init__(self, f):
            self.f, self.writes, self.flushes = f, 0, 0

        def write(self, s):
            self.writes += 1
            return self.f.write(s)

        def flush(self):
            self.flushes += 1
            return self.f.flush()

        def close(self):
            return self.f.close()
    svc = tservice.GroundTruthService(path=str(tmp_path / "gt.jsonl"))
    svc._journal = counter = Counter(svc._journal)
    client = tservice.StoreClient(tservice.InprocTransport(svc))
    rng = np.random.RandomState(0)
    client.add_many([(np.asarray(_profile(rng)), "w", {"chips": i}, 0.5)
                     for i in range(10)])
    assert (counter.writes, counter.flushes) == (1, 1)
    client.add(np.asarray(_profile(rng)), "w", {"chips": 1}, 0.5)
    assert (counter.writes, counter.flushes) == (2, 2)
    svc.close()


# ------------------------------------------------------------------ client

def test_store_client_piggyback_and_lookup_many_match_groundtruth():
    """A warm client answers lookups from its cached centroid model with
    no RPC, with the arithmetic of a bare GroundTruth, bit for bit."""
    class Counting(tservice.InprocTransport):
        n = 0

        def request(self, req):
            Counting.n += 1
            return super().request(req)
    gt = tgt.GroundTruth()
    client = tservice.StoreClient(Counting(tservice.GroundTruthService()))
    rng = np.random.RandomState(3)
    for i in range(6):
        p = np.asarray(_profile(rng, block=i % 2))
        gt.add(p, "w", {"chips": 4 + i}, 0.5 + 0.1 * i)
        client.add(p, "w", {"chips": 4 + i}, 0.5 + 0.1 * i)
    probes = [np.asarray(_profile(rng, block=i % 3, jitter=1.0))
              for i in range(20)]
    client.lookup(probes[0])                    # fetches the model once
    before = Counting.n
    got = [client.lookup(p) for p in probes]
    assert Counting.n == before                 # every warm lookup: 0 RPCs
    assert got == [gt.lookup(p) for p in probes]
    assert client.lookup_many(probes) == got
    assert client.hits + client.misses == 2 * len(probes) + 1


def test_store_client_from_args_inproc_reset_and_bad_spec(tmp_path):
    import argparse
    from repro_torch.launch.sysargs import (add_store_args,
                                            store_client_from_args)
    ap = add_store_args(argparse.ArgumentParser())
    journal = str(tmp_path / "gt.jsonl")
    client = store_client_from_args(ap.parse_args(["--gt-store", journal]))
    client.add(np.ones(4), "w", {"chips": 2}, 0.9)
    client.close()
    reopened = store_client_from_args(ap.parse_args(["--gt-store", journal]))
    assert reopened.snapshot()["n_entries"] == 1
    reset = store_client_from_args(ap.parse_args(["--gt-store", journal,
                                                  "--store-reset"]))
    assert reset.snapshot()["n_entries"] == 0
    with pytest.raises(ValueError, match="expected 'inproc'"):
        store_client_from_args(ap.parse_args(["--store", "redis://x"]))
    with pytest.raises(ValueError, match="--store-reset only applies"):
        store_client_from_args(ap.parse_args(["--store", "tcp://h:1",
                                              "--store-reset"]))


# ---------------------------------------------------------------- launcher

def _lines(main, capsys):
    main()
    return [line for line in capsys.readouterr().out.splitlines()
            if "energy" not in line and "executor=" not in line]


@pytest.mark.parametrize("server", ["port", "reference"])
def test_launcher_over_a_tcp_store_prints_the_reference_numbers(
        server, capsys, monkeypatch):
    args = ["--backend", "sim", "--system", "pipetune", "--scheduler",
            "hyperband", "--epochs", "9"]
    svc = PKGS[server].GroundTruthService()
    srv = PKGS[server].GroundTruthTCPServer(("127.0.0.1", 0), svc)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        tcp = _lines(lambda: tune_launch.main(
            args + ["--store", "tcp://127.0.0.1:%d" %
                    srv.server_address[1]]), capsys)
        snap = svc.handle({"op": "snapshot"})
    finally:
        srv.shutdown()
    inproc = _lines(lambda: tune_launch.main(args + ["--store", "inproc"]),
                    capsys)
    monkeypatch.setattr("sys.argv", ["tune", *args])
    reference = _lines(jtune_launch.main, capsys)
    assert tcp == inproc == reference
    assert "  best accuracy : 0.9953" in tcp
    assert "  ground truth  : 8 hits / 9 misses" in tcp
    assert snap["n_entries"] > 0        # the job's probes landed there


# ------------------------------------------------------------ kernel tuner

@pytest.fixture
def kernel_store(tmp_path):
    """A journaled store served in this process: (address, journal)."""
    journal = str(tmp_path / "store.jsonl")
    svc = tservice.GroundTruthService(path=journal)
    server = tservice.serve(svc, port=0, background=True)
    yield "tcp://127.0.0.1:%d" % server.server_address[1], journal
    server.shutdown()
    svc.close()


def test_kernel_tuner_store_sources_and_import(kernel_store, tmp_path,
                                               monkeypatch, capsys):
    """``tune --store`` persists the stored config under the CPU's
    hardware key; a second run (fresh find-db) answers from the store with
    0 trials and 0 kernel calls; ``show``/``export`` read the store and the
    journal alike; ``import`` loads a golden table into a store and into a
    stopped service's journal."""
    addr, journal = kernel_store
    monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert ktune.main(["tune", "--workload", "rglru@B=1,S=64,R=64",
                           "--device", "cpu", "--reps", "1", "--store",
                           addr]) == 0
        cold = json.loads(capsys.readouterr().out)[0]
        monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
        ktune.main(["tune", "--workload", "rglru@B=1,S=64,R=64",
                    "--device", "cpu", "--store", addr])
        warm = json.loads(capsys.readouterr().out)[0]
    finally:
        torch.set_num_threads(n)
    assert cold["source"] == "tuned" and cold["trials"] == 4
    assert (warm["source"], warm["trials"], warm["kernel_calls"]) == \
        ("find-db", 0, 0)
    assert warm["config"] == cold["config"]
    row = {"config": cold["config"], "hardware": "cpu/cpu",
           "kernel": "rglru", "objective": cold["tuned_s"],
           "shape": cold["shape"]}
    for src in (["--store", addr], ["--journal", journal]):
        ktune.main(["show", *src])
        assert json.loads(capsys.readouterr().out) == [row]
    out = tmp_path / "golden.json"
    ktune.main(["export", "--journal", journal, "--out", str(out)])
    assert tgt.load_golden(str(out)) == [row]
    capsys.readouterr()
    golden = tmp_path / "other.json"
    tgt.export_golden([{**row, "shape": "B=2,R=64,S=64"}], str(golden))
    ktune.main(["import", str(golden), "--store", addr])
    assert "store now holds 2" in capsys.readouterr().out
    stopped = str(tmp_path / "stopped.jsonl")
    ktune.main(["import", str(golden), "--journal", stopped])
    assert "journal now holds 1" in capsys.readouterr().out
    db = tgt.KernelConfigDB()
    assert ktune.install_kernel_db(addr, db) == 2
    assert ktune.install_kernel_db(stopped, db=tgt.KernelConfigDB()) == 1
    with pytest.raises(SystemExit, match="need a destination"):
        ktune.main(["import", str(golden)])
    with pytest.raises(tgt.GroundTruthError, match="no service journal"):
        ktune.main(["show", "--journal", str(tmp_path / "missing.jsonl")])
