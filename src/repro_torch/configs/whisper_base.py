"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865, head_dim=64,
    cross_attention=True, n_encoder_layers=6, n_frontend_tokens=1500,
    source="arXiv:2212.04356 (Whisper base: enc-dec; conv frontend is a stub)")
