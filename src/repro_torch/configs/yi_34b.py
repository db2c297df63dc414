"""Yi-34B [arXiv:2403.04652; hf]: llama-arch GQA, 60L d=7168 56H kv=8."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128, rope_theta=5e6)

REDUCED = ModelConfig(
    name="yi-34b-reduced", family="dense", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, rope_theta=5e6)
