"""Decode attention: the hand-written Hopper kernel's launcher.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py::
decode_attention_bhgd`` (``_decode_kernel``). The CUDA C++ source is
``csrc/decode_attention.cu``; its header says what bounds the kernel on
the H100 (bytes: at most ~2.4 MB of cache, ~0.7 us at the serving shape
B=32, S_max=144, Hkv=2, D=64 — below the launch latency) and what the
design does about it (several warps a block, 16-byte loads, the cache rows
split across the blocks of a thread-block cluster and merged there).

The TPU wrapper transposes the cache to ``(B·Hkv, S, D)`` on every call;
in eager PyTorch that would copy every layer's cache on every decode step.
This kernel reads one layer's cache ``(B, S_max, Hkv, D)`` where the model
keeps it, through strides, and reads the valid lengths from an int32
device tensor, so a decode step never waits on the host. It reads 16
bytes a lane, so q's and the caches' base pointers and batch, row and head
strides must be 16-byte aligned (``init_kv_cache`` makes them so).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

NAME = "decode_attention"
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128, 192, 224)
MAX_GROUP = 32  # q heads a kv head; a block takes 2 of them at a time
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the most blocks (batch, kv head and split) the split aims for: one a
#: streaming multiprocessor of the H100
TARGET_BLOCKS = 132
#: the fewest cache rows a split gets, unless there is one split. Measured
#: on the H100 (chip_smoke.py): at S_max = 144 one split beats every
#: split size at buckets 1 and 32; at S_max = 4096 and B = 1 eight splits
#: of 512 rows take under a third of one split's time
MIN_SPLIT_ROWS = 128
#: the splits of a (batch, kv head) form one thread-block cluster, whose
#: portable size is at most 8 blocks
MAX_SPLITS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _I, _P] + [_I] * 8 + [_L] * 10 + [_I, _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(batch: int, kv_heads: int, s_max: int) -> Tuple[int, int]:
    """(number of splits, rows a split) of the cache rows ``[0, s_max)``.

    Depends on the shapes alone, never on the lengths (they live on the
    device, and a captured decode loop replays one launch for every
    length): as many splits as fit ``batch · kv_heads · splits`` blocks in
    :data:`TARGET_BLOCKS`, at least one and at most :data:`MAX_SPLITS`, and
    none of fewer than :data:`MIN_SPLIT_ROWS` rows unless there is one. The
    splits cover ``s_max`` and the last one is not empty.
    """
    n = min(TARGET_BLOCKS // (batch * kv_heads), s_max // MIN_SPLIT_ROWS, MAX_SPLITS)
    split_len = _cdiv(s_max, max(n, 1))
    return _cdiv(s_max, split_len), split_len


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.decode_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
        lib.decode_attention_error_string.argtypes = [_I]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor, *,
                         split_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); caches: (B, S_max, Hkv, D); lengths: int32 CUDA
    tensor of 1 or B valid-entry counts → (B, 1, Hq, D).

    ``split_len`` overrides :func:`split_plan`'s rows a split (tests and
    measurements). One launch on the current stream (with more than one
    split, the splits of a (batch, kv head) run as one thread-block cluster
    and merge through its shared memory); it does not synchronise. Raises
    on anything the kernel does not take.
    """
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    b, _, hq, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError("k and v caches differ in shape")
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq} q heads over {hkv} kv heads: need a group of "
                         f"at most {MAX_GROUP}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}; the "
                        "kernel takes float32 or bfloat16, all alike")
    if lengths.dtype != torch.int32 or lengths.numel() not in (1, b):
        raise ValueError("lengths must be int32 with 1 or B entries")
    for t, dims in ((q, (0, 2)), (k_cache, (0, 1, 2)), (v_cache, (0, 1, 2))):
        if t.stride(-1) != 1:
            raise ValueError("the head dim must be contiguous (stride 1)")
        build.check_16b_layout(t, dims, "decode_attention")
    if split_len is None:
        n_splits, split_len = split_plan(b, hkv, s_max)
    elif split_len < 1:
        raise ValueError(f"split_len {split_len} < 1")
    else:
        n_splits = _cdiv(s_max, split_len)
    if n_splits > MAX_SPLITS:
        raise ValueError(f"{n_splits} splits of {split_len} rows: at most {MAX_SPLITS}")
    for t in (q, k_cache, v_cache, lengths):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("decode_attention kernel needs all inputs on one CUDA device")
    lengths = lengths.reshape(-1)
    len_stride = 0 if lengths.numel() == 1 else lengths.stride(0)
    o = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.decode_attention_fwd(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), len_stride, o.data_ptr(),
        DTYPE_CODES[q.dtype], b, s_max, hq, hkv, d, n_splits, split_len,
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        o.stride(0), o.stride(2),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        why = (lib.decode_attention_error_string(rc).decode() if rc > 0
               else "arguments refused")
        raise RuntimeError(f"decode_attention kernel failed ({rc}): {why}")
    return o
