"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, top_k=8,
    source="hf:Qwen/Qwen3-30B-A3B family (128 experts, top-8)")
