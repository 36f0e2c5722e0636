"""Model-layout entry points to the kernels, with their launch counts.

Each wrapper takes the model's tensors — q (B, S, Hq, D), k/v or one
layer's cache (B, S, Hkv, D), the mLSTM's q/k/v (B, S, H, D) and gates
(B, S, H), the SSD scan's x (B, S, H, P), dt (B, S, H) and shared B/C
(B, S, N) — and dispatches on where they lie:

* a CUDA tensor launches the hand-written kernel (or raises: there is no
  fallback), and only then adds one to the wrapper's ``launches`` count;
* a CPU tensor runs the plain PyTorch version from ``kernels/ref.py``.

None of the kernels has a backward (nor has any TPU kernel it replaces),
and a tensor a kernel fills through ctypes has no ``grad_fn``. So a
wrapper given a CUDA tensor that requires grad, while grad mode is on,
raises rather than return a result cut off from autograd. Training runs
inside :func:`plain_versions`: there, on this thread, every wrapper runs
its plain version on any device, keeps autograd and counts no launch, as
the JAX package trains through its plain attention (``use_pallas=False``).

The counts let a run show that its main path went through the kernels;
:func:`reset_launches` sets them to 0. They stay exact when several
threads launch at once (replicas of a pool serving from executor threads):
every change to a count holds one lock.

Under CUDA-graph capture a wrapper's kernel does not run: it is recorded
into the graph and runs at each replay, where no wrapper is called. So a
thread that captures counts its launches in a :func:`recording` of its own
(not in the shared counts, which another replica's thread may be adding
to at the same moment), and each replay adds what its graph recorded with
:func:`add_launches`.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mlstm_attention as _ml
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


_count_lock = threading.Lock()
_capturing = threading.local()  # .launches: this thread's recording, if any
_plain = threading.local()  # .on: this thread runs the plain versions


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a read, an add and a write, which
    two threads could otherwise interleave and lose a launch) — or, inside
    a :func:`recording` on this thread, to the recording instead."""
    recorded = getattr(_capturing, "launches", None)
    if recorded is not None:
        recorded[wrapper.__name__] += 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Within the block, this thread's launches go into the yielded
    ``Counter`` (by kernel name) and not into the shared counts: what a
    CUDA graph captured on this thread will launch at each replay. Other
    threads count as before."""
    if getattr(_capturing, "launches", None) is not None:
        raise RuntimeError("launch recordings do not nest")
    _capturing.launches = collections.Counter()
    try:
        yield _capturing.launches
    finally:
        _capturing.launches = None


def add_launches(counts) -> None:
    """Add ``counts`` (kernel name -> launches, from a :func:`recording`)
    to the shared counts: what one replay of a captured graph launched."""
    with _count_lock:
        for name, n in counts.items():
            WRAPPERS[name].launches += n


@contextlib.contextmanager
def plain_versions():
    """Within the block, on this thread only, every wrapper runs its plain
    version from ``kernels/ref.py`` on any device: autograd flows through
    it and no launch is counted. Other threads (a pool's replicas serving
    beside a trainer) keep launching the kernels."""
    before = plain_active()
    _plain.on = True
    try:
        yield
    finally:
        _plain.on = before


def plain_active() -> bool:
    """Whether this thread is inside :func:`plain_versions`."""
    return getattr(_plain, "on", False)


def _kernel_route(what: str, *tensors) -> bool:
    """True where the wrapper launches its kernel: a CUDA tensor outside
    :func:`plain_versions`. Raises if that kernel would be asked for a
    gradient it cannot give."""
    if plain_active() or tensors[0].device.type != "cuda":
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward and would return a result "
            "detached from autograd; train inside ops.plain_versions()")
    return True


def _no_kernel(t: torch.Tensor, what: str):
    return ValueError(f"{what}: no kernel for device {t.device} "
                      "(CUDA runs the kernel, the CPU its plain version)")


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) → (B, Sq, Hq, D).

    Sq and Sk may differ (the encoder-decoder's cross-attention), as in
    the TPU kernel: ``causal`` keeps key position <= query position,
    counted from the first row of each (top-left aligned)."""
    if _kernel_route("flash_attention", q, k, v):
        out = _fa.flash_attention_fwd(q, k, v, causal=causal)
        count_launch(flash_attention)
        return out
    if q.device.type == "cpu" or plain_active():
        return ref.flash_attention(q, k, v, causal=causal)
    raise _no_kernel(q, "flash_attention")


flash_attention.launches = 0


def decode_attention(q, k_cache, v_cache, cache_len):
    """q: (B, 1, Hq, D); caches: (B, S_max, Hkv, D); cache_len: valid
    entries, an int or an int tensor of 1 or B entries (on the card an
    int32 device tensor, so no host sync) → (B, 1, Hq, D)."""
    if _kernel_route("decode_attention", q, k_cache, v_cache):
        lengths = torch.as_tensor(cache_len, device=q.device)
        if lengths.dtype != torch.int32:
            lengths = lengths.to(torch.int32)
        out = _dec.decode_attention_fwd(q, k_cache, v_cache, lengths)
        count_launch(decode_attention)
        return out
    if q.device.type == "cpu" or plain_active():
        return ref.decode_attention(q, k_cache, v_cache, cache_len)
    raise _no_kernel(q, "decode_attention")


decode_attention.launches = 0


def mlstm_attention(q, k, v, log_i, log_f, *, chunk: int = 512):
    """Parallel mLSTM. q/k/v: (B, S, H, D); log_i, log_f: (B, S, H) f32
    (input-gate log, log-sigmoid forget) → y (B, S, H, D) in q's dtype.
    ``chunk`` is the plain version's query chunk (it bounds its
    temporaries); the kernel tiles on its own and computes the same y."""
    if _kernel_route("mlstm_attention", q, k, v, log_i, log_f):
        out = _ml.mlstm_attention_fwd(q, k, v, log_i, log_f)
        count_launch(mlstm_attention)
        return out
    if q.device.type == "cpu" or plain_active():
        return ref.mlstm_attention(q, k, v, log_i, log_f, chunk=chunk)
    raise _no_kernel(q, "mlstm_attention")


mlstm_attention.launches = 0


def ssd_scan(x, dt, a, b, c, *, chunk: int = 128):
    """Mamba-2 SSD scan from a zero state. x: (B, S, H, P); dt: (B, S, H)
    f32 (softplus'd); a: (H,) f32 (negative); b, c: (B, S, N) shared across
    heads → y (B, S, H, P) in x's dtype, no final state. The kernel runs
    ``min(chunk, max(S, 8))``-row chunks, the plain version ``chunk``-row
    ones: the same y up to rounding."""
    if _kernel_route("ssd_scan", x, dt, a, b, c):
        out = _ssd.ssd_scan_fwd(x, dt, a, b, c, chunk=chunk)
        count_launch(ssd_scan)
        return out
    if x.device.type == "cpu" or plain_active():
        return ref.ssd_scan(x, dt, a, b, c, chunk=chunk)
    raise _no_kernel(x, "ssd_scan")


ssd_scan.launches = 0

#: The ported kernels' wrappers, by kernel name.
WRAPPERS = {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "mlstm_attention": mlstm_attention, "ssd_scan": ssd_scan}


def reset_launches() -> None:
    with _count_lock:
        for fn in WRAPPERS.values():
            fn.launches = 0


def launches() -> dict:
    with _count_lock:
        return {name: fn.launches for name, fn in WRAPPERS.items()}
