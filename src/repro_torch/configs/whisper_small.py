"""whisper-small [audio] — enc-dec, 12L encoder + 12L decoder, d_model=768
12H (kv=12) d_ff=3072 vocab=51865; conv frontend is a STUB — input_specs()
supplies precomputed frame embeddings.  Learned positions, GELU MLP.
[arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    is_encdec=True,
    encoder_layers=12,
    mlp_gated=False,
    norm_type="layernorm",
    pos_embed="learned",
)
