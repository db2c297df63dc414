"""The port's kernel tuner and find-db against the reference's.

Workload parsing, shape keys, variant spaces and configs equal
``repro.kernels.tune``'s for the same specs; the ``KernelConfigDB`` cases of
tests/test_kernel_tune.py run over both packages; golden tables written by
either package load in the other with identical lookups; the port's
``tune_kernel`` on the CPU (plain versions) proposes the same trials, in the
same order, as the reference's in interpret mode, and a warm call runs no
trial; the CLI round-trips and refuses to run without a GPU unless
``--device cpu`` is given.
"""
import json

import pytest
import torch

import repro.api.experiment as jexperiment
import repro.core.groundtruth as jgt
from repro.kernels import tune as jtune
import repro_torch.api.experiment as texperiment
import repro_torch.core.groundtruth as tgt
from repro_torch.kernels import findb
from repro_torch.kernels import tune

SPECS = ["mlstm-smoke", "rglru-smoke", "flash-fwd-smoke", "flash-bwd-smoke",
         "train-smoke", "mlstm@B=8,S=2048,H=4,D=512",
         "rglru@B=8,S=2048,R=4096", "mlstm@B=1,S=96,H=1,D=8",
         "rglru@B=2,S=20,R=40", "flash_attention@B=1,S=64,K=1,G=2,D=8,"
         "T=48,causal=False,window=16"]

GT = {"reference": jgt, "port": tgt}


@pytest.fixture(autouse=True)
def _one_thread():
    """The train_step cases train LeNet on the CPU; a thread each keeps the
    suite's workers from crowding each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", SPECS)
def test_workload_parsing_matches_reference(spec):
    kernel, dims = tune.parse_workload(spec)
    assert (kernel, dims) == jtune.parse_workload(spec)
    assert tune.workload_shape_key(kernel, dims) == \
        jtune.workload_shape_key(kernel, dims)
    assert tune.kernel_space(kernel, dims).grid() == \
        jtune.kernel_space(kernel, dims).grid()
    for hp in tune.kernel_space(kernel, dims).grid() + [{}]:
        assert tune.variant_config(kernel, hp, {"chunk": 64}) == \
            jtune.variant_config(kernel, hp, {"chunk": 64})


def test_full_width_grids_and_bad_specs():
    for spec, n in (("mlstm@B=8,S=2048,H=4,D=512", 4),
                    ("rglru@B=8,S=2048,R=4096", 16)):
        assert len(tune.kernel_space(*tune.parse_workload(spec)).grid()) == n
    for bad in ("nope@B=1", "mlstm@B=1,S=2", "mlstm@B=1,S"):
        with pytest.raises(ValueError):
            tune.parse_workload(bad)
    assert findb.DEFAULTS == jtune.findb.DEFAULTS


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_db_exact_hardware_beats_wildcard_beats_default(pkg):
    db = GT[pkg].KernelConfigDB()
    db.put("mlstm", "B=1,S=256", {"chunk": 64})                   # "any"
    db.put("mlstm", "B=1,S=256", {"chunk": 32}, hardware="cpu/x86")
    assert db.get("mlstm", "B=1,S=256", "cpu/x86") == {"chunk": 32}
    assert db.get("mlstm", "B=1,S=256", "tpu/v5e") == {"chunk": 64}
    assert db.get("mlstm", "B=9,S=1") is None
    assert db.lookup_or_default("mlstm", "B=9,S=1",
                                {"chunk": 128}) == {"chunk": 128}
    got = db.lookup_or_default("mlstm", "B=1,S=256",
                               {"chunk": 128, "extra": 7}, "cpu/x86")
    assert got == {"chunk": 32, "extra": 7}


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_db_miss_never_blocks_or_mutates(pkg):
    db = GT[pkg].KernelConfigDB()
    default = {"q_block": 128, "kv_block": 128}
    assert db.lookup_or_default("flash_attention", "B=1", default) == default
    assert len(db) == 0
    default["q_block"] = -1
    assert db.lookup_or_default("flash_attention", "B=1",
                                {"q_block": 128})["q_block"] == 128


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_db_get_returns_copies(pkg):
    db = GT[pkg].KernelConfigDB()
    db.put("rglru", "S=512", {"chunk": 128, "r_block": 64})
    db.get("rglru", "S=512")["chunk"] = -1
    assert db.get("rglru", "S=512")["chunk"] == 128


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_golden_round_trip_identical_lookups(pkg, tmp_path):
    gt = GT[pkg]
    db = gt.KernelConfigDB()
    db.put("mlstm", "B=1,S=256", {"chunk": 64}, objective=5.4e-4)
    db.put("flash_attention", "B=1,S=256,causal=True",
           {"q_block": 64, "kv_block": 128}, hardware="cpu/x86",
           objective=1.2e-3)
    path = tmp_path / "golden.json"
    assert gt.export_golden(db.rows(), str(path)) == 2
    assert json.loads(path.read_text())["format"] == gt.GOLDEN_FORMAT
    fresh = gt.KernelConfigDB()
    assert fresh.merge_rows(gt.load_golden(str(path))) == 2
    assert fresh.rows() == db.rows()
    for k, s, h in [("mlstm", "B=1,S=256", "any"),
                    ("flash_attention", "B=1,S=256,causal=True", "cpu/x86")]:
        assert fresh.get(k, s, h) == db.get(k, s, h)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_golden_malformed_raises(pkg, tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"format": "something-else", "entries": []}))
    with pytest.raises(GT[pkg].GroundTruthError):
        GT[pkg].load_golden(str(path))


def test_golden_tables_cross_load_byte_identical(tmp_path):
    rows = [
        {"kernel": "mlstm", "shape": "B=8,D=512,H=4,S=2048",
         "hardware": "cuda/nvidia_h100_80gb_hbm3", "config": {"chunk": 64},
         "objective": 5.4e-3},
        {"kernel": "rglru", "shape": "B=8,R=4096,S=2048", "hardware": "any",
         "config": {"chunk": 128, "r_block": 64}, "objective": None},
    ]
    ours, theirs = tmp_path / "port.json", tmp_path / "reference.json"
    tgt.export_golden(rows, str(ours))
    jgt.export_golden(rows, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    tdb, jdb = tgt.KernelConfigDB(), jgt.KernelConfigDB()
    tdb.merge_rows(jgt.load_golden(str(ours)))      # port -> reference
    jdb.merge_rows(tgt.load_golden(str(theirs)))    # reference -> port
    assert tdb.rows() == jdb.rows() == tgt.load_golden(str(ours))
    for r in rows:
        for hw in (r["hardware"], "cpu/cpu"):
            assert tdb.get(r["kernel"], r["shape"], hw) == \
                jdb.get(r["kernel"], r["shape"], hw)
    assert tune.install_kernel_db(str(theirs), tgt.KernelConfigDB()) == 2


def _spy_runs(monkeypatch, module):
    """Record every Experiment.run result of `module`'s Experiment."""
    results = []
    run = module.Experiment.run

    def spy(self, *a, **kw):
        res = run(self, *a, **kw)
        results.append(res)
        return res

    monkeypatch.setattr(module.Experiment, "run", spy)
    return results


def _tune_and_warm(workload, db):
    got = tune.tune_kernel(workload, db=db, device="cpu", reps=1, warmup=0)
    assert got["source"] == "tuned" and got["hardware"] == "cpu/cpu"
    kernel = got["kernel"]
    assert db.get(kernel, got["shape"], "cpu/cpu") == got["config"]
    assert got["kernel_calls"][kernel] > got["trials"]
    # warm: the find-db answers with no trial and no kernel call
    warm = tune.tune_kernel(workload, db=db, device="cpu")
    assert warm["source"] == "find-db" and warm["trials"] == 0
    assert warm["kernel_calls"] == 0 and warm["config"] == got["config"]
    return got


def _trials(res):
    return [(tid, r.hparams) for tid, r in res.records.items()]


def test_tune_kernel_proposes_the_reference_trials(monkeypatch):
    ours = _spy_runs(monkeypatch, texperiment)
    theirs = _spy_runs(monkeypatch, jexperiment)
    got = _tune_and_warm("mlstm-smoke", tgt.KernelConfigDB())
    want = jtune.tune_kernel("mlstm-smoke", db=jgt.KernelConfigDB(),
                             interpret=True, reps=1, warmup=0)
    assert len(ours) == len(theirs) == 1
    assert _trials(ours[0]) == _trials(theirs[0])
    assert got["trials"] == want["trials"] == 4
    assert set(got["config"]) == set(want["config"])


def test_tune_rglru_proposes_the_reference_grid(monkeypatch):
    """The reference's Pallas rglru does not trace on jax 0.9, so its
    tune_kernel cannot run rglru: hold the port's trials against the
    reference scheduler's wave over the reference's space instead."""
    from repro.core.schedulers import GridSearch
    ours = _spy_runs(monkeypatch, texperiment)
    workload = "rglru@B=1,S=64,R=64"
    got = _tune_and_warm(workload, tgt.KernelConfigDB())
    wave = GridSearch(jtune.kernel_space(*jtune.parse_workload(workload)),
                      epochs=1).suggest()
    assert _trials(ours[0]) == [(p.trial_id, p.hparams) for p in wave]
    assert got["trials"] == len(wave) == 4


def test_kernel_tune_backend_is_registered():
    from repro_torch.api import registry
    be = registry.make_backend("kernel-tune", device="cpu", reps=2)
    assert isinstance(be, tune.KernelTuneBackend) and be.reps == 2


# train_step tunes since the tuner's train_step workload was ported (its
# case keeps its id and now runs the grid: 6 trials, then 0 when warm)
@pytest.mark.parametrize("spec,match", [
    ("flash-fwd-smoke", "item 8"), ("flash-bwd-smoke", "item 8"),
    pytest.param("train-smoke", None, id="train-smoke-2b")])
def test_untunable_workloads_name_their_roadmap_item(spec, match,
                                                    monkeypatch):
    if match is None:
        db = tgt.KernelConfigDB()
        runs = _spy_runs(monkeypatch, texperiment)
        got = tune.tune_kernel(spec, db=db, device="cpu")
        assert got["source"] == "tuned" and got["trials"] == 6
        # each trial timed its own remat x microbatches variant
        ran = [(r.hparams["remat"], r.hparams["microbatches"],
                r.epochs[0].sys_config) for r in runs[0].records.values()]
        assert sorted((rm, mb) for rm, mb, _ in ran) == sorted(
            (rm, mb) for rm in ("none", "block") for mb in (1, 2, 4))
        assert all(cfg == {"remat": rm, "microbatches": mb,
                           "precision": "fp32"} for rm, mb, cfg in ran)
        assert got["hardware"] == "cpu/cpu"
        assert set(got["config"]) == {"remat", "microbatches", "precision"}
        assert db.get("train_step", got["shape"], "cpu/cpu") == got["config"]
        warm = tune.tune_kernel(spec, db=db, device="cpu")
        assert warm["source"] == "find-db" and warm["trials"] == 0
        assert warm["config"] == got["config"]
    else:
        with pytest.raises(ValueError, match=match):
            tune.tune_kernel(spec, db=tgt.KernelConfigDB(), device="cpu")
    with pytest.raises(NotImplementedError, match="service.*item 12"):
        tune.install_kernel_db("tcp://127.0.0.1:1")


# the default (chunk 128 here) re-times at 1.00 and 1.05 in turn: a spread
# of 5%. A winner 2% faster is noise and the default is stored; one twice
# as fast is stored.
@pytest.mark.parametrize("winner_s,stored", [(0.98, 128), (0.5, 64)])
def test_a_win_within_the_defaults_spread_stores_the_default(
        winner_s, stored, monkeypatch):
    base = tune.variant_config("mlstm", {}, {})
    assert base == {"chunk": 128}
    calls = []

    def time_config(self, ts, cfg):
        if cfg == base:
            calls.append(cfg)
            t = 1.0 + 0.05 * (len(calls) % 2 == 0)
        else:
            t = winner_s if cfg["chunk"] == 64 else 2.0
        return t, [t], 0.0
    monkeypatch.setattr(tune.KernelTuneBackend, "_time_config", time_config)
    db = tgt.KernelConfigDB()
    got = tune.tune_kernel("mlstm-smoke", db=db, device="cpu")
    assert got["winner"] == {"chunk": 64} and got["winner_s"] == winner_s
    assert got["spread"] == pytest.approx(0.05)
    assert got["config"] == {"chunk": stored}
    assert db.get("mlstm", got["shape"], "cpu/cpu") == {"chunk": stored}
    assert got["tuned_s"] == (1.0 if stored == 128 else winner_s)


def test_hardware_key(monkeypatch):
    assert findb.hardware_key("cpu") == "cpu/cpu"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert findb.hardware_key("cuda") == "cuda/nvidia_h100_80gb_hbm3"


def test_cli_tune_show_export_round_trip(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
    golden, copy = tmp_path / "golden.json", tmp_path / "copy.json"
    argv = ["tune", "--workload", "mlstm-smoke", "--workload",
            "rglru@B=1,S=64,R=32", "--device", "cpu", "--reps", "1",
            "--golden", str(golden)]
    assert tune.main(argv) == 0
    first = json.loads(capsys.readouterr().out)
    assert [s["source"] for s in first] == ["tuned", "tuned"]
    assert [s["trials"] for s in first] == [4, 2]
    rows = jgt.load_golden(str(golden))             # the reference reads it
    assert {r["kernel"] for r in rows} == {"mlstm", "rglru"}
    assert all(r["hardware"] == "cpu/cpu" for r in rows)
    # a fresh process (a fresh db) warm-starts from the golden table
    monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
    assert tune.main(argv) == 0
    second = json.loads(capsys.readouterr().out)
    assert [s["source"] for s in second] == ["find-db", "find-db"]
    assert [s["config"] for s in second] == [s["config"] for s in first]
    assert tune.main(["show", "--golden", str(golden)]) == 0
    assert json.loads(capsys.readouterr().out) == rows
    assert tune.main(["export", "--golden", str(golden), "--out",
                      str(copy)]) == 0
    capsys.readouterr()
    assert copy.read_bytes() == golden.read_bytes()


def test_cli_without_gpu_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.main(["tune", "--workload", "mlstm-smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.KernelTuneBackend()


def _train_step_golden(path, config):
    db = tgt.KernelConfigDB()
    db.put("train_step", findb.train_step_shape_key(arch="lenet-mnist",
                                                    batch=64),
           config, hardware="cpu/cpu")
    tgt.export_golden(db.rows(), str(path))


TUNED = {"remat": "block", "microbatches": 2, "precision": "fp32"}


def test_train_step_baseline_spells_out_every_key(monkeypatch):
    """The baseline runs at the untuned config even with a tuned row in the
    find-db: explicit keys win in ``_effective_sys``."""
    db = tgt.KernelConfigDB()
    db.put("train_step", "arch=lenet-mnist,batch=64", TUNED,
           hardware="cpu/cpu")
    monkeypatch.setattr(findb, "_active_db", db)
    be = tune.KernelTuneBackend(device="cpu")
    ts = be.init_trial("train-smoke", {})
    _, res = be.run_epoch(ts, {})
    assert res.sys_config == tune.BASELINES["train_step"]
    assert list(be._real_states) == [
        ("train-smoke", "microbatches=1,precision=fp32,remat=none")]
    # the baseline's warm-up epoch and timed epoch, then the variant's
    # (the same config: its trial trains on, with no warm-up)
    assert be.kernel_calls["train_step"] == 4 + 4 + 4


def test_kernel_db_flag_installs_a_golden_table(tmp_path, monkeypatch,
                                                capsys):
    """--kernel-db in both launchers installs the golden table's rows into
    the process-wide find-db before the first step; a TorchRealBackend
    epoch that leaves the sys keys unset then runs the tuned config."""
    from repro_torch.core.backends import TorchRealBackend
    from repro_torch.launch import train as train_launch
    from repro_torch.launch import tune as tune_launch
    golden = tmp_path / "golden.json"
    _train_step_golden(golden, TUNED)
    monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
    res = train_launch.main(["--arch", "qwen3-0.6b-reduced", "--steps", "1",
                             "--batch", "2", "--seq", "16", "--device", "cpu",
                             "--kernel-db", str(golden)])
    assert res.kernel_db_rows == 1
    assert f"kernel find-db: 1 tuned configs from {golden}" in \
        capsys.readouterr().out
    monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
    tune_launch.main(["--backend", "sim", "--system", "v1", "--scheduler",
                      "random", "--epochs", "2", "--kernel-db", str(golden)])
    assert f"kernel find-db: 1 tuned configs from {golden}" in \
        capsys.readouterr().out
    be = TorchRealBackend(n_train=128, n_eval=32, steps_per_epoch=2,
                          device="cpu")
    _, epoch = be.run_epoch(be.init_trial("lenet-mnist", {}), {})
    assert epoch.sys_config == TUNED
    _, explicit = be.run_epoch(be.init_trial("lenet-mnist", {}),
                               {"microbatches": 1})
    assert explicit.sys_config == {**TUNED, "microbatches": 1}


def test_kernel_db_flag_refuses_a_journal_and_a_live_store(tmp_path,
                                                           monkeypatch):
    from repro_torch.launch import train as train_launch
    monkeypatch.setattr(findb, "_active_db", tgt.KernelConfigDB())
    journal = tmp_path / "journal.jsonl"
    journal.write_text(json.dumps({"op": "kernel_put"}) + "\n")
    for spec in (str(journal), "tcp://127.0.0.1:1"):
        with pytest.raises(NotImplementedError, match="service.*item 12"):
            train_launch.main(["--arch", "qwen3-0.6b-reduced", "--steps",
                               "1", "--device", "cpu", "--kernel-db", spec])
    assert findb.get_find_db().rows() == []
