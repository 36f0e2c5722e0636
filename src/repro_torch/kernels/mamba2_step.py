"""Mamba-2 decode step (Zamba2's one-token mixer): the hand-written Hopper
kernels' launcher.

Replaces no TPU kernel: the JAX package decodes through plain jnp ops,
which XLA fuses. The CUDA C++ source is ``csrc/mamba2_step.cu``; its header
says what bounds the step on the H100 (the f32 state, read once and written
once: 29.4 MB a layer at Zamba2-7B's bucket 8, ~8.8 us) and what the two
launches do: the conv, SiLU, dt, the state update, C·h, the D skip and the
gate in one block per (row, head, slice of P), then the group-wise RMS norm
from the slices' sums of squares, added in a fixed order.

It takes the in_proj output ``zx`` (B, 1, 2·d_inner + 2·G·N + H) as the
model computes it, through its row stride, and updates the SSM state
``h`` (B, H, P, N) f32 and the conv state (B, 3, conv_dim) in place.
Model-layout dispatch and the launch count live in ``kernels/ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NAME = "mamba2_step"
SUPPORTED_DIMS = (16, 64)  # P (head dim) and N (state size): the models' and reduced ones'
WIDTH = 4  # conv taps (Mamba-2's d_conv), fixed in the kernel
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the fewest (row, head, slice) blocks the plan aims for: four a streaming
#: multiprocessor of the H100, so that enough state loads are in flight
TARGET_BLOCKS = 4 * 132
#: the fewest rows of P a block takes
MIN_ROWS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 12 + [_I] * 8 + [ctypes.c_double] + [_L] * 4 + [_I, _P]


def splits(batch: int, heads: int, p: int) -> int:
    """The blocks a head's P rows are cut into: doubled from 1 while the
    blocks (batch · heads · splits) number fewer than
    :data:`TARGET_BLOCKS` and a block keeps at least :data:`MIN_ROWS`
    rows. Shapes only (a captured graph replays one launch)."""
    s = 1
    while batch * heads * s < TARGET_BLOCKS and p // (2 * s) >= MIN_ROWS:
        s *= 2
    return s


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.mamba2_step_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
        lib.mamba2_step_error_string.argtypes = [_I]
        lib.mamba2_step_error_string.restype = ctypes.c_char_p
    return lib


def mamba2_step_fwd(zx: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                    dt_bias: torch.Tensor, a_log: torch.Tensor, d_skip: torch.Tensor,
                    norm_scale: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor,
                    *, groups: int, eps: float) -> torch.Tensor:
    """zx: (B, 1, 2·d_inner + 2·G·N + H), the in_proj output; conv_w
    (4, conv_dim), conv_b (conv_dim,) and norm_scale (d_inner,) in zx's
    dtype; dt_bias, a_log, d_skip (H,) float32; h (B, H, P, N) float32,
    contiguous; conv_state (B, 3, conv_dim) in zx's dtype; all CUDA →
    the gated, normalised y (B, 1, d_inner) in zx's dtype. h and
    conv_state are updated in place.

    Launches on the current stream, allocates only its output and its
    scratch, and does not synchronise. Raises on anything the kernels do
    not take.
    """
    if h.dim() != 4:
        raise ValueError("mamba2_step takes a 4-D (B, H, P, N) state")
    bsz, n_heads, p, n = h.shape
    d_inner = n_heads * p
    conv_dim = d_inner + 2 * groups * n
    if groups <= 0 or n_heads % groups:
        raise ValueError(f"{n_heads} heads do not split into {groups} groups")
    if zx.shape != (bsz, 1, d_inner + conv_dim + n_heads):
        raise ValueError(f"zx {tuple(zx.shape)} is not (B, 1, 2·d_inner + 2·G·N + H) = "
                         f"{(bsz, 1, d_inner + conv_dim + n_heads)}")
    if conv_w.shape != (WIDTH, conv_dim):
        raise ValueError(f"conv weight {tuple(conv_w.shape)} is not ({WIDTH}, {conv_dim})")
    if conv_b.shape != (conv_dim,) or norm_scale.shape != (d_inner,):
        raise ValueError(f"conv bias {tuple(conv_b.shape)} / norm scale "
                         f"{tuple(norm_scale.shape)} are not ({conv_dim},) / ({d_inner},)")
    if conv_state.shape != (bsz, WIDTH - 1, conv_dim):
        raise ValueError(f"conv state {tuple(conv_state.shape)} is not "
                         f"{(bsz, WIDTH - 1, conv_dim)}")
    for t in (dt_bias, a_log, d_skip):
        if t.shape != (n_heads,):
            raise ValueError(f"dt_bias / a_log / d_skip {tuple(t.shape)} is not ({n_heads},)")
    if p not in SUPPORTED_DIMS or n not in SUPPORTED_DIMS:
        raise ValueError(f"head dim {p} / state size {n} not in {SUPPORTED_DIMS}")
    dtype = zx.dtype
    if dtype not in DTYPE_CODES or any(t.dtype != dtype for t in
                                       (conv_w, conv_b, norm_scale, conv_state)):
        raise TypeError(f"dtypes {zx.dtype}/{conv_w.dtype}/{conv_b.dtype}/"
                        f"{norm_scale.dtype}/{conv_state.dtype}; the kernels take float32 or "
                        "bfloat16, all alike")
    if any(t.dtype != torch.float32 for t in (dt_bias, a_log, d_skip, h)):
        raise TypeError("dt_bias, a_log, d_skip and the state must be float32")
    if not h.is_contiguous() or h.data_ptr() % 16:
        raise ValueError("the state must be contiguous and 16-byte aligned")
    for t in (dt_bias, a_log, d_skip, conv_b, norm_scale):
        if not t.is_contiguous():
            raise ValueError("dt_bias, a_log, d_skip, conv bias and norm scale must be "
                             "contiguous")
    if zx.stride(-1) != 1 or conv_w.stride(-1) != 1 or conv_state.stride(-1) != 1:
        raise ValueError("the last dim of zx, the conv weight and the conv state must be "
                         "contiguous (stride 1)")
    for t in (zx, conv_w, conv_b, dt_bias, a_log, d_skip, norm_scale, h, conv_state):
        if not t.is_cuda or t.device != zx.device:
            raise ValueError("mamba2_step kernel needs all inputs on one CUDA device")
    s = splits(bsz, n_heads, p)
    y = torch.empty((bsz, d_inner), dtype=torch.float32, device=zx.device)
    sq = torch.empty((bsz, n_heads * s), dtype=torch.float32, device=zx.device)
    out = torch.empty((bsz, 1, d_inner), dtype=dtype, device=zx.device)
    lib = _lib()
    rc = lib.mamba2_step_fwd(
        zx.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
        a_log.data_ptr(), d_skip.data_ptr(), norm_scale.data_ptr(), h.data_ptr(),
        conv_state.data_ptr(), y.data_ptr(), sq.data_ptr(), out.data_ptr(),
        DTYPE_CODES[dtype], bsz, n_heads, p, n, groups, WIDTH, s, float(eps),
        zx.stride(0), conv_w.stride(0), conv_state.stride(0), conv_state.stride(1),
        zx.device.index, torch.cuda.current_stream(zx.device).cuda_stream)
    if rc != 0:
        why = (lib.mamba2_step_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"mamba2_step kernel failed ({rc}): {why}")
    return out
