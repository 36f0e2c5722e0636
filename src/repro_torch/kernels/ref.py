"""Plain PyTorch versions of every ported kernel (same signatures as ops.py).

They reuse the model library's code, as the JAX package's
``kernels/ref.py`` re-exports its own: the CPU path and the oracle the
kernels are held to on the card are the same audited functions.
"""
from __future__ import annotations

from repro_torch.models.attention import (
    decode_attention as _decode_ref,
    reference_attention as _naive,
)


def flash_attention(q, k, v, *, causal: bool = True):
    """Plain version of ops.flash_attention (full-matrix GQA attention)."""
    return _naive(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Plain version of ops.decode_attention."""
    return _decode_ref(q, k_cache, v_cache, cache_len)


def mlstm_attention(q, k, v, log_i, log_f, *, chunk: int = 10**9):
    """Plain version of ops.mlstm_attention (the model's parallel mLSTM)."""
    from repro_torch.models.xlstm import _mlstm_parallel  # the model imports ops

    return _mlstm_parallel(q, k, v, log_i, log_f, chunk=chunk)


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """Plain version of ops.ssd_scan (the model's chunked SSD, y only)."""
    from repro_torch.models.ssm import ssd_chunked  # the model imports ops

    y, _ = ssd_chunked(x, dt, a, b, c, chunk=chunk)
    return y


def ssd_scan_sequential(x, dt, a, b, c):
    """Slow sequential oracle (the exact per-step recurrence)."""
    from repro_torch.models.ssm import ssd_reference

    y, _ = ssd_reference(x, dt, a, b, c)
    return y
