"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
    n_experts=128, top_k=1,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (MoE 128e top-1, early fusion)")
