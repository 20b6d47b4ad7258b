"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 on every layer.  bf16 params + 8-bit
Adam moments to fit 256 chips.  [hf:xai-org/grok-1; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    moe_d_ff=32768,
    vocab=131072,
    n_experts=8,
    top_k=2,
    moe_shard="ff",  # 8 big experts < model-axis 16 => TP the expert hidden
    param_dtype="bfloat16",
    opt_8bit=True,
    microbatches=8,
)
