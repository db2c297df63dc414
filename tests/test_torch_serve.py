"""The port's serve path against the JAX reference, reduced qwen3-0.6b on CPU.

Weights are drawn by the reference's ``init`` and carried over with
``weights.from_jax``; prompts and decode tokens come from numpy. Both run at
``precision="fp32"`` with ``q_chunk=kv_chunk=16``, once with
``use_pallas=True`` (JAX: the Pallas kernel in interpret mode; port: the
wrapper's plain version on CPU tensors) and once with ``use_pallas=False``.

Tolerances: prefill logits 1e-4, as tests/test_pallas_integration.py. The
caches hold bf16 in both packages, so they are compared at one bf16 step
(2**-7 relative): an fp32 difference in the last place can round one value
to the neighbouring bf16. Decode reads those bf16 caches; such a flip moves
the logits far less than 1e-4 at these widths (the largest decode
difference seen is 4e-7 with one flip in the cache), so decode logits are
held at 1e-4 too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import device as device_lib
from repro_torch import weights
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as TE
from repro_torch.models import transformer as TT

B, S, GEN = 2, 20, 6
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params_np():
    cfg = jconfigs.get_reduced("qwen3-0.6b")
    params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    return jax.tree.map(np.asarray, params)


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_prefill_and_decode_match_reference(params_np, use_pallas, window):
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-0.6b"),
                               window=window)
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3-0.6b"),
                               window=window)
    tparams = weights.from_jax(params_np, tcfg, "cpu")
    jsys = JT.SystemConfig(precision="fp32", use_pallas=use_pallas,
                           q_chunk=16, kv_chunk=16)
    tsys = TT.SystemConfig(precision="fp32", use_pallas=use_pallas,
                           q_chunk=16, kv_chunk=16)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feed = rng.integers(0, jcfg.vocab, (GEN, B, 1)).astype(np.int32)

    jl, jc = jax.jit(jsteps.make_prefill_step(jcfg, jsys, max_len=S + GEN))(
        params_np, {"tokens": jnp.asarray(prompts)})
    tl, tc = tsteps.make_prefill_step(tcfg, tsys, max_len=S + GEN)(
        tparams, {"tokens": torch.from_numpy(prompts).long()})
    assert tuple(tl.shape) == jl.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        assert tc[name].dtype == torch.bfloat16
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **CACHE_TOL)

    jdecode = jax.jit(jsteps.make_decode_step(jcfg, jsys))
    tdecode = tsteps.make_decode_step(tcfg, tsys)
    for i in range(GEN):
        jl, jc = jdecode(params_np, jc, jnp.asarray(feed[i]),
                         jnp.int32(S + i))
        tl, tc = tdecode(tparams, tc, torch.from_numpy(feed[i]).long(),
                         S + i)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **CACHE_TOL)


def test_serve_main_on_cpu():
    before = fa.launches
    res = serve.main(["--arch", "qwen3-0.6b-reduced", "--requests", "2",
                      "--prompt-len", "12", "--gen", "3", "--device", "cpu"])
    assert fa.launches == before == 0           # CPU: the plain version
    assert res.prefills == 2 and res.device_name == "cpu"
    assert tuple(res.tokens.shape) == (2, 3)
    assert tuple(res.prefill_logits.shape) == (2, 1, res.cfg.padded_vocab)
    assert bool(torch.isfinite(res.prefill_logits).all())
    assert res.cfg.dtype == torch.bfloat16 and res.sys.use_pallas


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-0.6b-reduced", "--requests", "1",
                    "--prompt-len", "4", "--gen", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init(torch.Generator(), tconfigs.get_reduced("qwen3-0.6b"))
    assert device_lib.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_arch_resolves_and_runs_forward(arch):
    """Each of the reference's archs resolves in the port, full and
    reduced, and the reduced config's forward gives finite logits."""
    cfg = tconfigs.get_reduced(arch)
    assert tconfigs.get_config(arch).name == arch
    assert tconfigs.get(f"{arch}-reduced") == cfg
    params = tsteps.model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 4)))
    sys_ = TT.SystemConfig(precision="fp32")
    if tsteps.is_encdec(cfg):
        frames = rng.standard_normal((1, cfg.n_enc_frames, cfg.d_model))
        logits, _ = TE.forward(params, {"frames": torch.from_numpy(
            frames).float(), "tokens": tokens}, cfg, sys_)
    elif cfg.takes_embeddings:
        emb = rng.standard_normal((1, 4, cfg.d_model))
        logits, _ = TT.forward(params, {"embeddings": torch.from_numpy(
            emb).float()}, cfg, sys_)
    else:
        logits, _ = TT.forward(params, {"tokens": tokens}, cfg, sys_)
    assert tuple(logits.shape) == (1, 4, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def test_arch_ids_match_reference_and_unknown_names_raise():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


def test_unknown_family_raises_value_error():
    cfg = dataclasses.replace(tconfigs.get_reduced("qwen3-0.6b"),
                              family="rnn")
    batch = {"tokens": torch.zeros((1, 1), dtype=torch.long)}
    with pytest.raises(ValueError, match="unknown family rnn"):
        TT.forward({}, batch, cfg)
    with pytest.raises(ValueError, match="unknown family rnn"):
        TT.init(torch.Generator(), cfg, "cpu")
    with pytest.raises(ValueError, match="unknown family rnn"):
        weights.leaf_shapes(cfg)
