"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attn, pattern 2:1.

38 layers = 12 x (rec, rec, local-attn) + 2 tail recurrent layers.
MQA (kv=1), head_dim 256, local window 2048.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    window=2048, rec_per_attn=2, d_rnn=4096)

REDUCED = ModelConfig(
    name="recurrentgemma-9b-reduced", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, head_dim=16, window=8,
    rec_per_attn=2, d_rnn=64)
