"""Parallel mLSTM (xLSTM prefill): the hand-written Hopper kernel's launcher.

Replaces the TPU kernel ``src/repro/kernels/mlstm_attention.py::
mlstm_attention_bhsd`` (``_mlstm_kernel``). The CUDA C++ source is
``csrc/mlstm_attention.cu``; its header says what bounds the kernel on the
H100 (bytes: ~134 MB, ~0.040 ms at xLSTM-1.3B's serving shape B=32,
S=128, H=4, D=1024, bf16, against ~4.3 GFLOP, ~0.004 ms) and what its two
designs do: bf16 runs on the tensor cores, 64-row query tiles with the
output's D split into slices of ``min(D, 128)`` columns across the blocks
of a thread-block cluster, which sums the slices' partial scores; float32
keeps the exact CUDA-core kernel. Both take an exact stabiliser from the
gates, so no running-max rescale.

For float32, like the TPU wrapper, this computes ``F = cumsum(log_f)``
outside the kernel; the bf16 kernel takes ``log_f`` and forms F itself,
so a bf16 call launches one kernel and nothing else. Unlike the TPU
wrapper, nothing is transposed to ``(B·H, S, D)`` or padded:
q/k/v ``(B, S, H, D)`` and the gates ``(B, S, H)`` go in through their
strides. The bf16 kernel moves 16 bytes a lane, so the launcher refuses
bf16 q, k or v whose base pointer or batch, row or head stride is not
16-byte aligned (the model's projections are). Model-layout dispatch and
the launch count live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "mlstm_attention"
SUPPORTED_HEAD_DIMS = (32, 64, 128, 256, 512, 1024)
#: output columns a block of the bf16 kernel takes; D / slice blocks form a cluster
SLICE = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_L] * 21 + [_I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.mlstm_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
        lib.mlstm_attention_error_string.argtypes = [_I]
        lib.mlstm_attention_error_string.restype = ctypes.c_char_p
    return lib


def mlstm_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_i: torch.Tensor, log_f: torch.Tensor) -> torch.Tensor:
    """q/k/v: (B, S, H, D); log_i, log_f: (B, S, H) float32; all CUDA →
    y (B, S, H, D) in q's dtype.

    Launches on the current stream and does not synchronise. Raises on
    anything the kernel does not take.
    """
    if q.dim() != 4:
        raise ValueError("mlstm_attention takes 4-D (B, S, H, D) q/k/v")
    b, s, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if log_i.shape != (b, s, h) or log_f.shape != (b, s, h):
        raise ValueError(f"gates {tuple(log_i.shape)}/{tuple(log_f.shape)} "
                         f"are not (B, S, H) = {(b, s, h)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes float32 or bfloat16, all alike")
    if log_i.dtype != torch.float32 or log_f.dtype != torch.float32:
        raise TypeError(f"gate dtypes {log_i.dtype}/{log_f.dtype}; the kernel takes float32")
    for t in (q, k, v):
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")
        if t.dtype == torch.bfloat16:
            build.check_16b_layout(t, (0, 1, 2), "mlstm_attention")
    for t in (q, k, v, log_i, log_f):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("mlstm_attention kernel needs all inputs on one CUDA device")
    # float32 reads F = cumsum(log f), bf16 reads log f: the kernel the
    # dtype picks gets its own and the other pointer is null
    if q.dtype == torch.float32:
        fcum = torch.cumsum(log_f, dim=1)
        fcum_ptr, fcum_st, logf_ptr, logf_st = fcum.data_ptr(), fcum.stride(), None, (0, 0, 0)
    else:
        fcum_ptr, fcum_st, logf_ptr, logf_st = None, (0, 0, 0), log_f.data_ptr(), log_f.stride()
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.mlstm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), fcum_ptr, logf_ptr, log_i.data_ptr(),
        o.data_ptr(), DTYPE_CODES[q.dtype], b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *fcum_st, *logf_st, *log_i.stride(), *o.stride()[:3],
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        why = (lib.mlstm_attention_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"mlstm_attention kernel failed ({rc}): {why}")
    return o
