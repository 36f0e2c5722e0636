"""Architecture config registry: ``get_config("<arch-id>")``.

Every architecture of the JAX package is registered; an unknown id raises
``KeyError``.
"""
from repro_torch.configs.base import ModelConfig, ShapeCell, SHAPES, SHAPES_BY_NAME  # noqa: F401

from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.internvl2_76b import CONFIG as _internvl
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless

REGISTRY = {
    "llama4-scout-17b-a16e": _llama4,
    "kimi-k2-1t-a32b": _kimi,
    "starcoder2-15b": _starcoder2,
    "qwen2-0.5b": _qwen2,
    "nemotron-4-340b": _nemotron,
    "yi-34b": _yi,
    "zamba2-1.2b": _zamba2,
    "xlstm-1.3b": _xlstm,
    "internvl2-76b": _internvl,
    "seamless-m4t-large-v2": _seamless,
}

ARCH_IDS = tuple(REGISTRY)

#: Architectures the JAX package has and the port does not have yet.
NOT_PORTED = ()


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}") from None
