"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d=2048, 60e top-4 + 4 shared."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151936, head_dim=128, n_experts=60, top_k=4,
    n_shared=4, qkv_bias=True)

REDUCED = ModelConfig(
    name="qwen2-moe-a2.7b-reduced", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=32, vocab=256, head_dim=16, n_experts=8,
    top_k=4, n_shared=2, qkv_bias=True)
