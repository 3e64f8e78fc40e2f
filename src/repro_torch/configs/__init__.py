"""Architecture registry (a copy of ``repro/configs``): the 10 assigned
architectures (exact public hyperparameters) + the shape cells.  ``get_arch(name)`` accepts either the
canonical dashed id (``--arch qwen3-0.6b``) or the module name."""

from repro_torch.configs.base import SHAPES, ArchConfig, FLPlan, ShapeConfig

from repro_torch.configs import (command_r_plus_104b, granite_moe_3b_a800m,
                                 internlm2_1_8b, internvl2_26b,
                                 jamba_v0_1_52b, mamba2_2_7b, minitron_4b,
                                 qwen3_0_6b, qwen3_moe_235b_a22b,
                                 whisper_base)

_MODULES = [
    qwen3_0_6b, minitron_4b, internlm2_1_8b, command_r_plus_104b,
    granite_moe_3b_a800m, qwen3_moe_235b_a22b, internvl2_26b,
    jamba_v0_1_52b, whisper_base, mamba2_2_7b,
]

ARCHS: dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ARCH_NAMES = list(ARCHS)


def get_arch(name: str) -> ArchConfig:
    key = name.replace("_", "-").lower()
    if key in ARCHS:
        return ARCHS[key]
    # allow module-style ids too
    for cfg in ARCHS.values():
        if cfg.name.replace("-", "").replace(".", "") == \
                key.replace("-", "").replace(".", ""):
            return cfg
    raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")


__all__ = ["ARCHS", "ARCH_NAMES", "get_arch", "ArchConfig", "ShapeConfig",
           "SHAPES", "FLPlan"]
