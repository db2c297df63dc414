"""Whisper-small [arXiv:2212.04356]: enc-dec 12L/12L d=768 12H, conv stub."""
from repro_torch.models.encdec import EncDecConfig

CONFIG = EncDecConfig(
    name="whisper-small", n_layers=12, d_model=768, n_heads=12, d_ff=3072,
    vocab=51865, n_enc_frames=1500)

REDUCED = EncDecConfig(
    name="whisper-small-reduced", n_layers=2, d_model=64, n_heads=4, d_ff=128,
    vocab=256, n_enc_frames=32)
