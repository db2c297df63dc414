"""xLSTM-350M [arXiv:2405.04517]: mLSTM + sLSTM blocks, d_ff=0 (internal expansion).

24 layers = 3 x (7 mLSTM + 1 sLSTM) per the paper's 7:1 ratio.
"""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024, n_heads=4,
    n_kv_heads=4, d_ff=0, vocab=50304, mlstm_per_slstm=7, proj_factor=2.0)

REDUCED = ModelConfig(
    name="xlstm-350m-reduced", family="ssm", n_layers=3, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=0, vocab=256, mlstm_per_slstm=2, proj_factor=2.0)
