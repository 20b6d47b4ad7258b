"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
SSD (state-space duality) with state=128, head_dim=64, expand=2, conv=4.
Runs the long_500k shape (linear-time scan).  [arXiv:2405.21060; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
)
