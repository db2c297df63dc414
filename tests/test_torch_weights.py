"""Port parameter layout and configs against the reference; import guard."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.models import transformer as TT

ROOT = Path(__file__).resolve().parents[1]


def test_leaf_shapes_match_reference_at_full_width():
    jcfg = jconfigs.get_config("qwen3-0.6b")
    abstract = jax.eval_shape(lambda k: JT.init(k, jcfg),
                              jax.random.PRNGKey(0))
    ref = {p: tuple(a.shape) for p, a in weights.flatten(abstract).items()}
    assert weights.leaf_shapes(tconfigs.get_config("qwen3-0.6b")) == ref


def test_config_copies_match_reference():
    for get in ("get_config", "get_reduced"):
        j = dataclasses.asdict(getattr(jconfigs, get)("qwen3-0.6b"))
        t = dataclasses.asdict(getattr(tconfigs, get)("qwen3-0.6b"))
        assert j.pop("dtype") == np.float32 and t.pop("dtype") == torch.float32
        assert j == t
    jsys = dataclasses.asdict(JT.SystemConfig())
    tsys = dataclasses.asdict(TT.SystemConfig())
    assert set(jsys) == set(tsys)
    assert {k for k in jsys if jsys[k] != tsys[k]} == {"use_pallas"}
    assert tconfigs.get("qwen3-0.6b-reduced").name == "qwen3-0.6b-reduced"


def test_from_jax_round_trip_and_init_layout():
    cfg = jconfigs.get_reduced("qwen3-0.6b")
    tcfg = tconfigs.get_reduced("qwen3-0.6b")
    params = jax.jit(JT.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    params_np = jax.tree.map(np.asarray, params)
    tparams = weights.from_jax(params_np, tcfg, "cpu")
    flat_j = weights.flatten(params_np)
    flat_t = weights.flatten(tparams)
    assert set(flat_t) == set(flat_j)
    for path, leaf in flat_t.items():
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), flat_j[path])
    own = weights.flatten(TT.init(torch.Generator().manual_seed(0), tcfg,
                                  "cpu"))
    assert {p: tuple(a.shape) for p, a in own.items()} == \
        weights.leaf_shapes(tcfg)


def test_from_jax_rejects_unknown_missing_and_misshapen():
    tcfg = tconfigs.get_reduced("qwen3-0.6b")
    good = {p: np.zeros(s, np.float32)
            for p, s in weights.leaf_shapes(tcfg).items()}
    with pytest.raises(KeyError, match="lm_head"):
        weights.from_jax({**good, "lm_head": np.zeros((1,))}, tcfg, "cpu")
    with pytest.raises(KeyError, match="embed"):
        weights.from_jax({p: a for p, a in good.items() if p != "embed"},
                         tcfg, "cpu")
    with pytest.raises(ValueError, match="final_norm"):
        weights.from_jax({**good, "final_norm/scale": np.zeros((3,))}, tcfg,
                         "cpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) >= 3
    files += examples + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    banned = {"jax", "jaxlib", "flax", "repro"}
    for f in files:
        found = banned & set(_imported_roots(f))
        assert not found, f"{f.relative_to(ROOT)} imports {sorted(found)}"
