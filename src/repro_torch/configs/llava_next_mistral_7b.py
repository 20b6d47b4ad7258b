"""llava-next-mistral-7b [vlm] — Mistral-7B backbone: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000; anyres patch frontend is a STUB —
input_specs() supplies 576 precomputed, projected patch embeddings.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    n_image_patches=576,
    microbatches=2,
)
