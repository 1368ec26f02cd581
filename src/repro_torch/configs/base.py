"""Architecture configuration schema and the dry run's input shapes (the
port's copy of ``repro/configs/base.py``).

Every architecture has one module in ``repro_torch.configs`` exporting
``CONFIG``; ``repro_torch.configs.get(name)`` resolves them. ``reduced()``
produces the CPU smoke-test variant (2 layers, d_model <= 512, <= 4
experts).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1             # apply MoE every k-th layer (jamba: 2)
    moe_group: int = 256           # one-hot dispatch group size (perf lever)
    # attention pattern
    window: int = 0                # sliding-window size (0 = full attention)
    global_every: int = 0          # gemma3: 1 global layer every k (k=6 -> 5:1)
    attn_every: int = 0            # jamba: 1 attention layer every k (k=8 -> 1:7)
    # modality / structure
    cross_attention: bool = False  # whisper-style enc-dec decoder
    n_encoder_layers: int = 0
    n_frontend_tokens: int = 0     # audio frames / vision patches (stub embeds)
    # ssm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                # mamba inner expansion
    rwkv_head_dim: int = 64
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    kv_dtype: str = ""            # "" = model dtype; "int8" = quantized cache
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab + 127) // 128) * 128

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k: SSM, hybrid, or sliding-window dense."""
        return self.family in ("ssm", "hybrid") or (
            self.window > 0 and self.global_every > 0)

    def reduced(self) -> "ArchConfig":
        """2-layer, d_model<=512, <=4-expert CPU smoke variant (same family)."""
        d = min(self.d_model, 128)
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0
        return dataclasses.replace(
            self,
            n_layers=2,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            global_every=min(self.global_every, 2) if self.global_every else 0,
            moe_every=min(self.moe_every, 2),
            d_model=d, n_heads=heads, n_kv_heads=kv,
            head_dim=(32 if self.head_dim else 0),
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            window=min(self.window, 16) if self.window else 0,
            rwkv_head_dim=16,
            d_state=8,
            dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
