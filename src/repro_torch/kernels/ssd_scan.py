"""Mamba-2 SSD chunked scan (Zamba2 prefill): the hand-written Hopper
kernel's launcher.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan_bhsd``
(``_ssd_kernel``). The CUDA C++ source is ``csrc/ssd_scan.cu``; its header
says what bounds the kernel on the H100 (bytes: ~69 MB, ~0.021 ms at
Zamba2-1.2B's serving shape B=32, S=128, H=64, P=N=64, bf16, against ~13
GFLOP, ~0.013 ms) and how its design carries the (P × N) f32 state from
chunk to chunk.

Like the TPU kernel it takes no initial state and returns no final state,
and it takes the same chunk, ``min(chunk, max(S, 8))``. Unlike the TPU
wrapper, nothing is transposed to ``(B·H, S, P)`` or padded: x
``(B, S, H, P)``, dt ``(B, S, H)`` and the shared B and C ``(B, S, N)`` go
in through their strides, and the ragged last chunk is masked in the
kernel. Model-layout dispatch and the launch count live in
``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
SUPPORTED_DIMS = (8, 16, 32, 64, 128)  # P (head dim) and N (state size)
MAX_CHUNK = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_L] * 13 + [_I, _P]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
        lib.ssd_scan_error_string.argtypes = [_I]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """x: (B, S, H, P); dt: (B, S, H) float32; a: (H,) float32; b, c:
    (B, S, N) in x's dtype; all CUDA → y (B, S, H, P) in x's dtype.

    Launches on the current stream and does not synchronise. Raises on
    anything the kernel does not take.
    """
    if x.dim() != 4:
        raise ValueError("ssd_scan takes a 4-D (B, S, H, P) x")
    bsz, s, h, p = x.shape
    if dt.shape != (bsz, s, h):
        raise ValueError(f"dt {tuple(dt.shape)} is not (B, S, H) = {(bsz, s, h)}")
    if a.shape != (h,):
        raise ValueError(f"a {tuple(a.shape)} is not (H,) = {(h,)}")
    if b.dim() != 3 or b.shape[:2] != (bsz, s) or c.shape != b.shape:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} are not the "
                         f"same (B, S, N) with (B, S) = {(bsz, s)}")
    n = b.shape[2]
    if p not in SUPPORTED_DIMS or n not in SUPPORTED_DIMS:
        raise ValueError(f"head dim {p} / state size {n} not in {SUPPORTED_DIMS}")
    q = min(chunk, max(s, 8))  # the chunk the TPU kernel runs
    if not 0 < q <= MAX_CHUNK:
        raise ValueError(f"chunk {q} not in 1..{MAX_CHUNK}")
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}/{b.dtype}/{c.dtype}; the kernel takes "
                        "float32 or bfloat16, all alike")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt/a dtypes {dt.dtype}/{a.dtype}; the kernel takes float32")
    for t in (x, dt, a, b, c):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("ssd_scan kernel needs all inputs on one CUDA device")
    for t in (x, b, c):
        if t.stride(-1) != 1:
            raise ValueError("the last dim of x, b and c must be contiguous (stride 1)")
    a = a.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), DTYPE_CODES[x.dtype], bsz, s, h, p, n, q,
        *x.stride()[:3], *dt.stride(), *b.stride()[:2], *c.stride()[:2],
        *y.stride()[:3], x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        why = (lib.ssd_scan_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"ssd_scan kernel failed ({rc}): {why}")
    return y
