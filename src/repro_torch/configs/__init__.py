"""Architecture config registry: ``get_config("<arch-id>")``.

Only the architectures whose model family the port runs are registered;
the others raise with a message saying they are not ported yet.
"""
from repro_torch.configs.base import ModelConfig  # noqa: F401

from repro_torch.configs.qwen2_0_5b import CONFIG as _qwen2
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

REGISTRY = {
    "qwen2-0.5b": _qwen2,
    "xlstm-1.3b": _xlstm,
    "zamba2-1.2b": _zamba2,
}

ARCH_IDS = tuple(REGISTRY)

#: Architectures the JAX package has and the port does not have yet.
NOT_PORTED = (
    "llama4-scout-17b-a16e",
    "kimi-k2-1t-a32b",
    "starcoder2-15b",
    "nemotron-4-340b",
    "yi-34b",
    "seamless-m4t-large-v2",
    "internvl2-76b",
)


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        if arch in NOT_PORTED:
            raise NotImplementedError(
                f"arch {arch!r} is not ported to PyTorch yet; "
                f"ported: {sorted(REGISTRY)}") from None
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}") from None
