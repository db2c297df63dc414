"""Qwen2-1.5B [arXiv:2407.10671; hf]: GQA kv=2, QKV bias."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536, n_heads=12,
    n_kv_heads=2, d_ff=8960, vocab=151936, head_dim=128, qkv_bias=True,
    rope_theta=1e6)

REDUCED = ModelConfig(
    name="qwen2-1.5b-reduced", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, qkv_bias=True)
