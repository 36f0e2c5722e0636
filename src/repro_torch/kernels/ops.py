"""Model-layout entry points to the kernels, with their launch counts.

Each wrapper takes the model's tensors — q (B, S, Hq, D), k/v or one
layer's cache (B, S, Hkv, D), the mLSTM's q/k/v (B, S, H, D) and gates
(B, S, H) — and dispatches on where they lie:

* a CUDA tensor launches the hand-written kernel (or raises: there is no
  fallback), and only then adds one to the wrapper's ``launches`` count;
* a CPU tensor runs the plain PyTorch version from ``kernels/ref.py``.

The counts let a run show that its main path went through the kernels;
:func:`reset_launches` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_attention as _ml
from repro_torch.kernels import ref


def _no_kernel(t: torch.Tensor, what: str):
    return ValueError(f"{what}: no kernel for device {t.device} "
                      "(CUDA runs the kernel, the CPU its plain version)")


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) → (B, S, Hq, D)."""
    if q.device.type == "cuda":
        out = _fa.flash_attention_fwd(q, k, v, causal=causal)
        flash_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal)
    raise _no_kernel(q, "flash_attention")


flash_attention.launches = 0


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (B, 1, Hq, D); caches: (B, S_max, Hkv, D); cache_len: valid
    entries, an int or an int tensor of 1 or B entries (on the card an
    int32 device tensor, so no host sync) → (B, 1, Hq, D)."""
    if q.device.type == "cuda":
        lengths = torch.as_tensor(cache_len, device=q.device)
        if lengths.dtype != torch.int32:
            lengths = lengths.to(torch.int32)
        out = _dec.decode_attention_fwd(q, k_cache, v_cache, lengths)
        decode_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, cache_len)
    raise _no_kernel(q, "decode_attention")


decode_attention.launches = 0


def mlstm_attention(q, k, v, log_i, log_f, *, chunk: int = 512):
    """Parallel mLSTM. q/k/v: (B, S, H, D); log_i, log_f: (B, S, H) f32
    (input-gate log, log-sigmoid forget) → y (B, S, H, D) in q's dtype.
    ``chunk`` is the plain version's query chunk (it bounds its
    temporaries); the kernel tiles on its own and computes the same y."""
    if q.device.type == "cuda":
        out = _ml.mlstm_attention_fwd(q, k, v, log_i, log_f)
        mlstm_attention.launches += 1
        return out
    if q.device.type == "cpu":
        return ref.mlstm_attention(q, k, v, log_i, log_f, chunk=chunk)
    raise _no_kernel(q, "mlstm_attention")


mlstm_attention.launches = 0

#: The ported kernels' wrappers, by kernel name.
WRAPPERS = {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "mlstm_attention": mlstm_attention}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
