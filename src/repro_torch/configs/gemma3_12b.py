"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, d_ff=15360, vocab=262144, head_dim=256,
    window=1024, global_every=6,
    source="hf:google/gemma-3 family (5:1 local:global sliding window, 128k)")
