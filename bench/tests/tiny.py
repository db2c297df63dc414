"""Tiny configurations and cells for the CPU tests: the cells' own
traffic at a few rows of 64 tokens, the program in float32 (where its
numbers meet the reference's to rounding) unless a test asks for bf16."""
from bench.harness import spec

DENSE = {"name": "tiny-dense", "family": "dense", "reference": "transformer",
         "hidden_size": 64, "intermediate_size": 128,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 2, "vocab_size": 250, "rope_theta": 10000.0}

CELLS = tuple(w["name"] for w in spec.load_benchmark()["workloads"])


def cell(name: str, precision: str = "fp32", cfg=None):
    """(traffic, config) of a cell cut to the CPU: a dense configuration at
    a tiny size, or ``cfg``."""
    tr = dict(spec.traffic(name), precision=precision)
    tr.update(batch=2 if tr["kind"] == "train" else 4, seq=64)
    return tr, cfg or DENSE
