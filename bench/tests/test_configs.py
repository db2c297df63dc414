"""Each configuration file parses, states what it changed from its source,
and lays its weights out as the program does."""
import re

import pytest
import torch

from bench.harness import program, spec, weights

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTHS = {"hidden_size", "intermediate_size", "num_attention_heads",
          "num_key_value_heads", "head_dim"}
CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_file(name):
    cfg = spec.config(name)
    entry = next(c for c in spec.load_benchmark()["configs"]
                 if c["name"] == name)
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]
    for key in cfg["reduced"]:
        assert NAME.match(key)
        assert key not in WIDTHS and not key.endswith(("_dim", "_rank"))
        assert key in cfg and key in cfg["published"]
        assert cfg[key] != cfg["published"][key]
    assert cfg["num_attention_heads"] % cfg["num_key_value_heads"] == 0


FILES = sorted(p.stem for p in (spec.BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("name", FILES)
def test_layout_is_the_programs(name):
    cfg = spec.config(name)
    ours = {p: s for p, (s, _) in weights.layout(cfg).items()}
    assert ours == {p: tuple(s) for p, s in
                    program.leaf_shapes(program.model_config(cfg)).items()}


def test_weights_come_from_the_seed():
    from bench.tests import tiny
    a = weights.init_params(tiny.DENSE, 2 ** 31 + 5, "cpu")
    b = weights.init_params(tiny.DENSE, 2 ** 31 + 5, "cpu")
    c = weights.init_params(tiny.DENSE, 2 ** 31 + 6, "cpu")
    assert all((a[k] == b[k]).all() for k in a)
    assert any((a[k] != c[k]).any() for k in a)
    assert all(t.dtype == torch.float32 for t in a.values())
