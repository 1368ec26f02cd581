"""Architecture config (the port's copy of the reference's data)."""
from .base import ArchConfig
CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=0, n_kv_heads=0, d_ff=8960, vocab=65536, rwkv_head_dim=64,
    source="arXiv:2404.05892 (RWKV6 Finch: data-dependent decay)")
