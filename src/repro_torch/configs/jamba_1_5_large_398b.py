"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
    n_experts=16, top_k=2, moe_every=2, attn_every=8,
    source="arXiv:2403.19887 (Jamba: mamba:attn 7:1 interleave, MoE 16e top-2)")
