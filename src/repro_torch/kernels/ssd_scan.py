"""Mamba-2 SSD chunked scan (Zamba2 prefill): the hand-written Hopper
kernel's launcher.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py::ssd_scan_bhsd``
(``_ssd_kernel``). The CUDA C++ source is ``csrc/ssd_scan.cu``; its header
says what bounds the kernel on the H100 (bytes: ~69 MB, ~0.021 ms at
Zamba2-1.2B's serving shape B=32, S=128, H=64, P=N=64, bf16, against ~13
GFLOP, ~0.013 ms) and what its two designs do: bf16 at P, N >= 16 runs on
the tensor cores, one block per (batch row, group of heads) sharing C·Bᵀ;
float32, and bf16 at P or N = 8, keep the exact CUDA-core kernel.

Like the TPU kernel it takes no initial state and returns no final state,
and it takes the same chunk, ``min(chunk, max(S, 8))``. Unlike the TPU
wrapper, nothing is transposed to ``(B·H, S, P)`` or padded: x
``(B, S, H, P)``, dt ``(B, S, H)`` and the shared B and C ``(B, S, N)`` go
in through their strides, and the ragged last chunk is masked in the
kernel. The tensor-core kernel moves 16 bytes a lane, so for it the
launcher refuses x, B or C whose base pointer or batch, row or head stride
is not 16-byte aligned (the model's views of its conv output are).
Model-layout dispatch and the launch count live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import build

NAME = "ssd_scan"
SUPPORTED_DIMS = (8, 16, 32, 64, 128)  # P (head dim) and N (state size)
MMA_DIMS = (16, 32, 64, 128)  # P and N of the bf16 tensor-core kernel
MAX_CHUNK = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: heads a tensor-core block may take, the most first
HEADS_PER_BLOCK = (8, 4, 2, 1)
#: the fewest blocks the plan aims for: one a streaming multiprocessor of the H100
TARGET_BLOCKS = 132
#: dynamic shared memory a block may use on the H100
MAX_SMEM = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 8 + [_L] * 13 + [_I, _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def uses_tensor_cores(dtype: torch.dtype, p: int, n: int) -> bool:
    """Whether x of ``dtype`` with head dim ``p`` and state size ``n`` runs
    the tensor-core kernel (by dtype and shape only)."""
    return dtype == torch.bfloat16 and p in MMA_DIMS and n in MMA_DIMS


def mma_smem_bytes(p: int, n: int, q: int, heads: int, n_buf: int, carry: bool) -> int:
    """Shared memory of a tensor-core block (``mma_smem`` in the source):
    B and C tiles, ``n_buf`` x tiles and the y staging, bf16 with rows
    padded by 8, for the chunk's rows rounded up to 16; cum, dt and the
    state-update scale for each head; the heads' f32 states if carried."""
    qr = 16 * _cdiv(q, 16)
    return (2 * qr * (n + 8) * 2 + (n_buf + 1) * qr * (p + 8) * 2 + 3 * heads * qr * 4
            + (heads * p * (n + 8) * 4 if carry else 0))


def heads_per_block(batch: int, heads: int, p: int, n: int, q: int, n_chunks: int) -> int:
    """G, the heads a tensor-core block takes: the most of
    :data:`HEADS_PER_BLOCK` whose blocks (batch · ceil(heads / G)) still
    number :data:`TARGET_BLOCKS` and whose states fit in shared memory
    (with one x buffer), else 1. Shapes only: C·Bᵀ is computed once for G
    heads, so larger G does less of it, smaller G fills more of the card."""
    for g in HEADS_PER_BLOCK:
        if g > 1 and (batch * _cdiv(heads, g) < TARGET_BLOCKS
                      or mma_smem_bytes(p, n, q, g, 1, n_chunks > 1) > MAX_SMEM):
            continue
        return g
    return 1


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

    A tensor-core block takes :func:`heads_per_block` heads. Launches on
    the current stream and does not synchronise. Raises on anything the
    kernel does not take.
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
    for t in (x, b, c):
        if t.stride(-1) != 1:
            raise ValueError("the last dim of x, b and c must be contiguous (stride 1)")
    n_chunks = _cdiv(s, q)
    mma = uses_tensor_cores(x.dtype, p, n)
    if mma:
        build.check_16b_layout(x, (0, 1, 2), "ssd_scan")
        build.check_16b_layout(b, (0, 1), "ssd_scan")
        build.check_16b_layout(c, (0, 1), "ssd_scan")
        g = heads_per_block(bsz, h, p, n, q, n_chunks)
    else:
        g = 1
    for t in (x, dt, a, b, c):
        if not t.is_cuda or t.device != x.device:
            raise ValueError("ssd_scan kernel needs all inputs on one CUDA device")
    a = a.contiguous()
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    lib = _lib()
    rc = lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), DTYPE_CODES[x.dtype], bsz, s, h, p, n, q, g,
        *x.stride()[:3], *dt.stride(), *b.stride()[:2], *c.stride()[:2],
        *y.stride()[:3], x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        why = (lib.ssd_scan_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"ssd_scan kernel failed ({rc}): {why}")
    return y
