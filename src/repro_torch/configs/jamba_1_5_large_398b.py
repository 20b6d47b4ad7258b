"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2 on every other layer,
Mamba:attention 1:7 interleave (1 attention layer per 8, offset 4).
Mamba layers use the Mamba2/SSD formulation (TPU adaptation — DESIGN.md §5).
bf16 params + 8-bit Adam moments.  [arXiv:2403.19887; hf]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    moe_d_ff=24576,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=128,
    ssm_groups=8,
    ssm_conv=4,
    param_dtype="bfloat16",
    opt_8bit=True,
    microbatches=8,
)
