"""InternVL2-26B [arXiv:2404.16821; hf]: InternViT + InternLM2 backbone.

The ViT frontend is a stub, as in the reference: the model takes
precomputed patch embeddings (B, S, d); this config is the LM backbone.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=16384, vocab=92553, head_dim=128)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16)
