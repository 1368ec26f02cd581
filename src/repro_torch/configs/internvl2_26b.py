"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab=92553, head_dim=128,
    n_frontend_tokens=256,
    source="arXiv:2404.16821 (InternVL2-26B: InternViT stub + InternLM2 LM)")
