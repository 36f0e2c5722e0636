"""Prefill (flash) attention: the hand-written Hopper kernel's launcher.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_bhsd`` (``_flash_kernel``). The CUDA C++ source is
``csrc/flash_attention.cu``; its header says what bounds the kernel on
the H100 (bytes: ~16.8 MB, ~5 us at the serving shape B=32, S=128, Hq=14,
Hkv=2, D=64, against ~1 us of causal flops) and what the design does
about it: bf16 runs on the tensor cores (``mma.sync``), float32 keeps an
exact-f32 CUDA-core loop.

Unlike the TPU wrapper, which flattens heads to ``(B·H, S, D)``, the kernel
takes the model layout ``(B, S, H, D)`` with explicit strides, so no
transpose or copy of q, k or v happens per call. The bf16 kernel moves 16
bytes a lane, so the launcher refuses bf16 tensors whose base pointer or
batch, row or head stride is not 16-byte aligned (the model's q, k and v
are contiguous). Model-layout dispatch and the launch count live in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "flash_attention"
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 192, 224)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P] + [_I] * 8 + [_L] * 12 + [_I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
        lib.flash_attention_error_string.argtypes = [_I]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D), CUDA → (B, Sq, Hq, D).

    Sq and Sk may differ, as in the TPU kernel: keys at or past Sk are
    masked and the causal mask is top-left aligned (key <= query
    position). Launches on the current stream and does not synchronise.
    Raises on anything the kernel does not take.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes 4-D (B, S, H, D) tensors")
    b, s, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes float32 or bfloat16, all alike")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")
        if t.dtype == torch.bfloat16:
            build.check_16b_layout(t, (0, 1, 2), "flash_attention")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention kernel needs q, k, v on one CUDA device")
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        DTYPE_CODES[q.dtype], b, s, sk, hq, hkv, d, int(causal),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        why = (lib.flash_attention_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"flash_attention kernel failed ({rc}): {why}")
    return o
