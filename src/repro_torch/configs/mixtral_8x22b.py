"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d=6144, 48H GQA kv=8, 8e top-2, SWA."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=16384, vocab=32768, head_dim=128, n_experts=8, top_k=2,
    window=4096, rope_theta=1e6)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, n_experts=4,
    top_k=2, window=8, rope_theta=1e6)
