"""The port's trial dispatch (``repro_torch.service.dispatch`` and
``service.worker``, ``python -m repro_torch.worker``) against in-process
runs and the reference.

- A remote ``sim`` worker gives the records of the port's and the
  reference's in-process runs, bit for bit, across HyperBand's rung
  resumes; ``run_many`` carries a wave in one round-trip, a worker without
  it is replayed per trial, a connection dropped mid-batch loses no trial
  and runs none twice, PBT clones follow their source, and server errors
  surface by name.
- A ``python -m repro_torch.worker`` subprocess does the same; one asked
  for the card on a host without one refuses to start, and a ``real``
  worker left to its default device refuses the bind.
- ``TorchRealBackend`` trials run remotely on the CPU equal the in-process
  ones bit for bit, and so do the LM example's backend, loaded into a
  worker subprocess through ``--plugin``.
- Record payloads are the reference's: each package reads the other's,
  numpy scalars in hparams and sys configs included.
"""
import socket
import threading

import numpy as np
import pytest
import torch

import repro.core.pipetune as jpipetune
import repro.service.dispatch as jdispatch
import repro_torch.api as tapi
import repro_torch.service as tservice
from repro.api import Experiment as JExperiment
from repro_torch.core.backends import EpochResult
from repro_torch.core.job import HPTJob, Param, SearchSpace
from repro_torch.core.pipetune import TrialRecord
from repro_torch.core.profiler import EpochProfile
from repro_torch.service import dispatch
from repro_torch.service.transport import _recv_msg, _send_msg
from torch_service_util import ROOT, assert_same, spawn, stop


def _space():
    return SearchSpace([
        Param("batch_size", "choice", choices=(32, 64, 256, 1024)),
        Param("learning_rate", "log", 0.001, 0.1)])


def _job(epochs=9):
    return HPTJob(workload="lenet-mnist", space=_space(), max_epochs=epochs)


def _sim(scheduler="hyperband", executor=None, **kw):
    return (tapi.Experiment(_job()).with_tuner("v1").with_backend("sim")
            .with_scheduler(scheduler, **kw).run(executor=executor))


def _records(res, durations=True):
    return {t: ([e.accuracy for e in r.epochs],
                [e.loss for e in r.epochs],
                [e.duration_s for e in r.epochs] if durations else None,
                r.sys_history, r.hparams, r.gt_hit, r.probe_epochs)
            for t, r in sorted(res.records.items())}


class Counting(tservice.TrialWorkerService):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.ops = []

    def handle(self, req):
        self.ops.append(req.get("op"))
        return super().handle(req)


@pytest.fixture
def worker_server():
    made = []

    def make(service=None):
        server = tservice.serve_worker(
            service or tservice.TrialWorkerService(), port=0,
            background=True)
        made.append(server)
        return "tcp://127.0.0.1:%d" % server.server_address[1]

    yield make
    for server in made:
        server.shutdown()
        server.service.close()


def _pool(*addrs, **kw):
    return tapi.WorkerPoolExecutor([tapi.RemoteWorker(a, **kw)
                                    for a in addrs])


# --------------------------------------------------------------- sim worker

def test_remote_sim_worker_equals_inproc_and_the_reference(worker_server):
    ex = _pool(worker_server())
    try:
        remote = _sim(executor=ex)
        worker = ex.workers[0]
        assert worker.capabilities().remote
        assert worker.runner_spec == {"tuner": "v1", "tuner_kw": {},
                                      "backend": "sim", "backend_kw": {}}
    finally:
        ex.close()
    serial = _sim()
    ref = (JExperiment(_job()).with_tuner("v1").with_backend("sim")
           .with_scheduler("hyperband").run())
    assert _records(remote) == _records(serial)
    assert_same(_records(remote, durations=False),
                _records(ref, durations=False))
    assert all(r.remote for r in remote.records.values())
    assert any(len(r.epochs) > 1 for r in remote.records.values())


@pytest.mark.parametrize("wire", ["json", "binary"])
def test_run_many_carries_a_wave_and_stays_bit_identical(worker_server,
                                                         wire):
    services = [Counting(), Counting()]
    ex = _pool(*[worker_server(s) for s in services], wire=wire)
    try:
        remote = _sim("random", executor=ex, n_trials=6)
    finally:
        ex.close()
    assert _records(remote) == _records(_sim("random", n_trials=6))
    for s in services:
        assert "run_many" in s.ops and "run" not in s.ops
    assert sum(len(s.runner.records) for s in services) == 6


def test_a_worker_without_run_many_is_replayed_per_trial(worker_server):
    class Old(Counting):
        def handle(self, req):
            if req.get("op") == "run_many":
                self.ops.append("run_many")
                return {"ok": False, "error": "unknown op 'run_many'"}
            return super().handle(req)
    svc = Old()
    ex = _pool(worker_server(svc))
    try:
        remote = _sim("random", executor=ex, n_trials=4)
        assert not ex.workers[0]._batched_runs
    finally:
        ex.close()
    assert _records(remote) == _records(_sim("random", n_trials=4))
    assert svc.ops.count("run_many") == 1 and svc.ops.count("run") == 4


def test_a_mid_batch_drop_loses_no_trial_and_runs_none_twice(worker_server):
    class DropOnce(Counting):
        def handle(self, req):
            if req.get("op") == "run_many" and "run_many" not in self.ops:
                self.ops.append("run_many")
                raise tservice.DropConnection("mid-batch")
            return super().handle(req)
    dropping, survivor = DropOnce(), Counting()
    ex = _pool(worker_server(dropping), worker_server(survivor))
    ex.pool.retire_on_error = True
    try:
        remote = _sim("random", executor=ex, n_trials=6)
        assert len(ex.pool.workers) == 1
    finally:
        ex.close()
    assert _records(remote) == _records(_sim("random", n_trials=6))
    assert len(survivor.runner.records) == 6


def test_pbt_clones_follow_their_source(worker_server):
    ex = _pool(worker_server(), worker_server())
    try:
        remote = _sim("pbt", executor=ex, population=4, interval=3)
    finally:
        ex.close()
    assert _records(remote) == _records(_sim("pbt", population=4,
                                             interval=3))


def test_server_errors_surface_by_name(worker_server):
    from repro_torch.obs.events import EventBus
    service = tservice.TrialWorkerService()
    service.bus = EventBus()        # the hello must not stamp this process
    worker = tapi.RemoteWorker(worker_server(service))
    try:
        with pytest.raises(tservice.WorkerError, match="unknown op"):
            worker._request({"op": "drop_all"})
        with pytest.raises(tservice.WorkerError, match="bind"):
            worker._request({"op": "run", "workload": "w", "trial_id": "t",
                             "hparams": {}, "epochs": 1})
        with pytest.raises(tservice.WorkerError,
                           match="obs_trace without a trace id"):
            worker._request({"op": "obs_trace"})
        assert worker.enable_trace("t" * 16) is True
        assert service.bus.trace_id == "t" * 16
        assert worker.transport.trace == "t" * 16
        with pytest.raises(tservice.WorkerError, match="no-such-backend"):
            worker._request({"op": "bind",
                             "spec": {"backend": "no-such-backend"}})
    finally:
        worker.close()


def test_transport_death_names_the_worker():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    probe.listen(1)
    probe.settimeout(10)
    port = probe.getsockname()[1]

    def one_hello_then_die():
        conn, _ = probe.accept()
        conn.settimeout(10)
        req = _recv_msg(conn)
        if req.get("op") == "_wire":
            _send_msg(conn, {"ok": False, "error": "unsupported"})
            req = _recv_msg(conn)
        _send_msg(conn, {"ok": True, "kind": "remote", "capacity": 1})
        conn.close()

    threading.Thread(target=one_hello_then_die, daemon=True).start()
    worker = tapi.RemoteWorker(f"tcp://127.0.0.1:{port}", runner_spec={})
    with pytest.raises(tapi.WorkerLostError,
                       match=f"tcp://127.0.0.1:{port}.*'run'") as err:
        worker._request({"op": "run", "workload": "w", "trial_id": "t",
                         "hparams": {}, "epochs": 1})
    assert err.value.worker_lost
    worker.close()
    probe.close()
    with pytest.raises(tapi.WorkerLostError, match=f"127.0.0.1:{port}"):
        tapi.RemoteWorker(f"tcp://127.0.0.1:{port}", connect_timeout=0.2,
                          connect_retries=0)


# ------------------------------------------------------------ subprocesses

def test_python_m_repro_torch_worker_subprocess():
    proc, line, addr = spawn(["repro_torch.worker", "--port", "0"],
                             "trial worker on")
    try:
        ex = _pool(addr)
        try:
            remote = _sim(executor=ex)
        finally:
            ex.close()
    finally:
        stop(proc)
    assert _records(remote) == _records(_sim())


def test_a_worker_without_a_card_refuses_the_card():
    """No worker trains on the CPU when it finds no GPU: asked for the card
    (``--device cuda``) it exits naming the device; left to its default, a
    ``real`` backend refuses the bind."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.worker", "--port", "0",
         "--device", "cuda"], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT), env={**__import__("os").environ,
                            "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode != 0 and "cuda" in (out.stdout + out.stderr).lower()
    svc = tservice.TrialWorkerService(backend="real")
    resp = svc.handle({"op": "bind", "spec": {}})
    assert not resp["ok"] and "cpu" in resp["error"]


# ------------------------------------------------- real and lm backends

SMALL = {"n_train": 128, "n_eval": 32, "steps_per_epoch": 2}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fixed_clock(monkeypatch):
    """``TorchRealBackend`` times its steps on the host clock, and PipeTune
    both locks the fastest probed config and matches the store on those
    times, so two jobs on a loaded host can part ways. Here the backend's
    clock advances one millisecond a read, so every step (and every build)
    lasts exactly that long in both jobs: the clock the remote and the
    in-process job read is the same, whichever thread reads it."""
    import itertools
    import types

    import repro_torch.core.backends as backends
    ticks, lock = itertools.count(), threading.Lock()

    def perf_counter():
        with lock:
            return next(ticks) * 1e-3

    monkeypatch.setattr(backends, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))


def _real_job():
    return HPTJob(workload="lenet-mnist", space=SearchSpace([
        Param("batch_size", "choice", choices=(32, 64)),
        Param("learning_rate", "log", 0.01, 0.1)]), max_epochs=2)


@pytest.mark.parametrize("tuner", ["v1", "pipetune"])
def test_real_backend_remote_equals_inproc_on_the_cpu(worker_server,
                                                      one_thread,
                                                      fixed_clock, tuner):
    """``TorchRealBackend`` trials on a remote worker (served here, so the
    CPU's thread count is the in-process run's) give the in-process
    records bit for bit: losses, accuracies, sys histories; PipeTune's
    store lookups run out of process, against the same TCP store. Both
    jobs read one fixed clock (``fixed_clock``), so PipeTune's choices,
    which follow step times, cannot differ with the host's load."""
    kw = dict(SMALL, device="cpu")

    def run(executor=None, store=None):
        exp = (tapi.Experiment(_real_job()).with_backend("real", **kw)
               .with_scheduler("random", n_trials=2))
        if tuner == "pipetune":
            exp = exp.with_tuner("pipetune", max_probes=1) \
                .with_groundtruth(store)
        else:
            exp = exp.with_tuner("v1")
        return exp.run(executor=executor)

    def tcp_store():
        svc = tservice.GroundTruthService()
        srv = tservice.serve(svc, port=0, background=True)
        return srv, tservice.StoreClient(tservice.SocketTransport(
            *srv.server_address[:2]))

    srv, store = tcp_store()
    ex = _pool(worker_server())
    try:
        remote = run(ex, store)
        spec = ex.workers[0].runner_spec
    finally:
        ex.close()
        store.close()
        srv.shutdown()
    srv, store = tcp_store()
    try:
        local = run(store=store)
    finally:
        store.close()
        srv.shutdown()
    assert spec["backend_kw"] == kw
    assert _records(remote, durations=False) == \
        _records(local, durations=False)
    assert (remote.gt_hits, remote.gt_misses) == \
        (local.gt_hits, local.gt_misses)


def test_lm_backend_through_a_plugin_worker(one_thread):
    """The LM example registers its backend as ``lm``; a worker subprocess
    imports it with ``--plugin`` and runs a trial at the example's reduced
    width on the CPU (one torch thread on both sides): the record equals
    the in-process one, losses bit for bit."""
    import importlib
    import sys
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        importlib.import_module("torch_tune_llm_sysparams")
    finally:
        sys.path.remove(str(ROOT / "examples"))
    proc, _, addr = spawn(
        ["repro_torch.worker", "--port", "0", "--plugin",
         "torch_tune_llm_sysparams", "--backend", "lm", "--device", "cpu"],
        "trial worker on", env={"OMP_NUM_THREADS": "1"},
        extra_path=[ROOT / "examples"])
    job = HPTJob(workload="tune-lm", space=SearchSpace(
        [Param("learning_rate", "log", 1e-4, 1e-2)]), max_epochs=1)

    def run(executor=None):
        return (tapi.Experiment(job).with_tuner("v1")
                .with_backend("lm", steps_per_epoch=2, device="cpu")
                .with_scheduler("random", n_trials=1).run(executor=executor))
    try:
        ex = _pool(addr)
        try:
            remote = run(ex)
        finally:
            ex.close()
    finally:
        stop(proc)
    local = run()
    got, want = _records(remote, False), _records(local, False)
    assert got == want
    (losses,) = [v[1] for v in got.values()]
    assert len(losses) == 1 and np.isfinite(losses[0])


# ----------------------------------------------------------------- payloads

def _record(hparams, sys_cfg):
    e = EpochResult(duration_s=np.float64(1.25), energy_j=2.5,
                    loss=np.float32(0.75), accuracy=0.5,
                    profile=EpochProfile({"a": np.float32(1.5)}, raw=True),
                    sys_config=sys_cfg, step_times=[np.float64(0.5), 0.75],
                    compile_s=0.125)
    return TrialRecord(trial_id="t0", hparams=hparams, epochs=[e],
                       sys_history=[sys_cfg], gt_hit=True, probe_epochs=2)


@pytest.mark.parametrize("name", ["json", "tlv"])
def test_record_payloads_cross_the_packages(name):
    """A record whose hparams and sys config hold numpy scalars and a 0-d
    tensor goes over every codec as Python numbers, and each package reads
    the other's payload to the same record."""
    rec = _record({"learning_rate": np.float32(0.1),
                   "batch_size": np.int64(64), "dropout": torch.tensor(0.5)},
                  {"microbatches": np.int64(2), "remat": "block"})
    codec = tservice.get_codec(name)
    payload = codec.decode(codec.encode(dispatch.record_to_payload(rec)))
    assert payload["hparams"] == {"learning_rate": float(np.float32(0.1)),
                                  "batch_size": 64, "dropout": 0.5}
    assert type(payload["epochs"][0]["sys_config"]["microbatches"]) is int
    theirs = jdispatch.record_from_payload(payload)
    ours = dispatch.record_from_payload(payload)
    assert isinstance(theirs, jpipetune.TrialRecord)
    assert_same(jdispatch.record_to_payload(theirs),
                dispatch.record_to_payload(ours))
    assert_same(dispatch.record_to_payload(ours), payload)
