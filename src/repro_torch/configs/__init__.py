"""Assigned-architecture configs (--arch <id>) + paper-workload configs."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    SUBQUADRATIC_FAMILIES,
    InputShape,
    ModelConfig,
)

from repro_torch.configs.qwen1_5_32b import CONFIG as _qwen32
from repro_torch.configs.starcoder2_3b import CONFIG as _sc3
from repro_torch.configs.starcoder2_15b import CONFIG as _sc15
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.mamba2_780m import CONFIG as _mamba
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba

ARCHS = {
    c.name: c
    for c in (
        _qwen32, _sc3, _sc15, _qwen110, _llava,
        _qwen3moe, _grok, _mamba, _whisper, _jamba,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}"
        )
    return ARCHS[name]


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, honoring the long_500k skip rule."""
    cells = []
    for name, cfg in ARCHS.items():
        for shape in SHAPES.values():
            if (
                shape.name == "long_500k"
                and cfg.family not in SUBQUADRATIC_FAMILIES
            ):
                continue
            cells.append((name, shape.name))
    return cells
