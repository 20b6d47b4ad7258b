"""Model configuration dataclass + the assigned input-shape table."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | vlm | moe | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 ⇒ d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (qwen3-moe uses 1536)
    moe_every: int = 1  # MoE MLP at layers where i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # "expert": shard the expert axis over `model` (EP; needs n_experts
    # divisible by the model-axis size).  "ff": keep experts replicated and
    # tensor-shard each expert's hidden dim (few-big-experts models).
    moe_shard: str = "expert"
    moe_groups: int = 64  # dispatch groups (GShard-style; ≥ data shards)

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: attention at layers i % attn_every == attn_offset
    attn_offset: int = 0

    # --- enc-dec (audio) ---
    is_encdec: bool = False
    encoder_layers: int = 0

    # --- VLM ---
    n_image_patches: int = 0

    # --- numerics / memory policy ---
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"  # large models override to bfloat16
    opt_8bit: bool = False  # int8 block-quantized Adam moments
    remat: bool = True
    microbatches: int = 1
    scan_layers: bool = True

    # --- attention implementation ---
    attn_chunk: int = 1024  # KV-chunked (online-softmax) attention block
    mlp_gated: bool = True  # SwiGLU (False ⇒ plain GELU MLP)
    pos_embed: str = "rope"  # "rope" | "learned"
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    max_positions: int = 0  # learned-pos table size; 0 ⇒ sized per shape
    scan_unroll: bool = False  # unroll all scans (roofline cost variants)
    ssd_chunk: int = 256  # SSD chunk length (mamba2)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every:
            return i % self.attn_every == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.n_experts:
            return False
        return i % self.moe_every == self.moe_offset

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests.

        Keeps every structural switch (GQA grouping, MoE top-k, hybrid
        interleave pattern, enc-dec, biases, norms) while shrinking width,
        depth, vocab, and expert count.
        """
        period = 1
        if self.attn_every:
            period = self.attn_every
        if self.n_experts:
            period = _lcm(period, self.moe_every)
        small = dict(
            name=self.name + "-smoke",
            n_layers=2 * period,
            d_model=64,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16 if self.n_heads else 0,
            d_ff=128 if self.d_ff else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_groups=min(self.ssm_groups, 2) if self.ssm_state else 1,
            encoder_layers=2 if self.is_encdec else 0,
            n_image_patches=8 if self.n_image_patches else 0,
            param_dtype="float32",
            compute_dtype="float32",
            opt_8bit=self.opt_8bit,
            attn_chunk=64,
            max_positions=128,
            microbatches=1,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned shape set (applies to every architecture; long_500k only for
# sub-quadratic archs — see DESIGN.md §5).
SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# archs whose token mixing is sub-quadratic (run long_500k)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")
