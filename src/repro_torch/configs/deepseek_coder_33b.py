"""DeepSeek-Coder-33B [arXiv:2401.14196; hf]: llama-arch GQA, 62L d=7168."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256, head_dim=128,
    rope_theta=1e5)

REDUCED = ModelConfig(
    name="deepseek-coder-33b-reduced", family="dense", n_layers=2, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16)
