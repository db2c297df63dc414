"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family]: qk_norm, GQA kv=8, head_dim=128."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024, n_heads=16,
    n_kv_heads=8, d_ff=3072, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True)

REDUCED = ModelConfig(
    name="qwen3-0.6b-reduced", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, qk_norm=True,
    tie_embeddings=True)
