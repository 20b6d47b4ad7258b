"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4, head_dim 128)
per-expert d_ff=1536, vocab=151936, MoE 128 experts top-8 on every layer.
bf16 params + 8-bit Adam moments to fit 256 chips (DESIGN.md §6).
[hf:Qwen/Qwen3-30B-A3B family; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,          # listed d_ff is the per-expert hidden
    moe_d_ff=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    param_dtype="bfloat16",
    opt_8bit=True,
    microbatches=8,
)
