"""The yardstick: the card's peaks and the operations and bytes of each
kernel launch and of a served request, counted from shapes.

Frozen copies of ``chip_smoke.py``'s ``bound``, ``union_length``,
``port_kernel`` and its per-kernel counts, so that a change to the program
cannot move the ruler it is measured with. A launch's bound is the larger
of its operations over the bf16 peak and its bytes over the HBM bandwidth;
each input byte is counted read once and each output byte written once.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12

#: name prefix of each port kernel's entry functions -> its kernel
KERNEL_PREFIXES = {"flash_": "flash_attention", "decode_": "decode_attention",
                   "mlstm_": "mlstm_attention", "ssd_": "ssd_scan"}

BF16 = 2  # bytes an element


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: max(ops / peak, bytes / bandwidth)."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total, reach = total + e - s, e
        elif e > reach:
            total, reach = total + e - reach, e
    return total


def port_kernel(name: str) -> Optional[str]:
    """The port kernel a profiled device kernel's name belongs to, or None."""
    m = re.search(r"\(anonymous namespace\)::([a-z_]+_kernel)\b", name)
    if not m or "at::" in name:
        return None
    return next((k for p, k in KERNEL_PREFIXES.items() if m.group(1).startswith(p)), None)


# ------------------------------------------------------------ kernel launches
def flash_cost(b: int, s: int, hq: int, hkv: int, d: int) -> Tuple[float, float]:
    """(bytes, flops) of one causal flash launch: q, k, v read, out written."""
    nbytes = BF16 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    flops = 4 * b * hq * d * s * (s + 1) / 2
    return nbytes, flops


def decode_cost(b: int, length: int, hq: int, hkv: int, d: int) -> Tuple[float, float]:
    """(bytes, flops) of one decode-attention launch over ``length`` cache
    rows: q read, out written, the rows' K and V read, the length read."""
    nbytes = BF16 * (2 * b * hq * d + 2 * b * length * hkv * d) + 4
    flops = 4 * b * hq * d * length
    return nbytes, flops


# ------------------------------------------------------------- model counts
def attention_layers(model: Dict) -> int:
    """Attention applications a token passes: every layer of a decoder."""
    if model["family"] != "dense":
        raise ValueError(f"no counts for the {model['family']!r} family")
    return model["num_layers"]


def _hd(model: Dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["num_heads"]


def _ffn_matrices(model: Dict) -> int:
    return 3 if model.get("activation", "silu") == "silu" else 2


def token_matmul_flops(model: Dict) -> float:
    """Matrix-product flops of one token through every layer (no head, no
    attention scores)."""
    d, f, hd = model["d_model"], model["d_ff"], _hd(model)
    hq, hkv = model["num_heads"], model["num_kv_heads"]
    attn = 2 * d * hd * (hq + 2 * hkv) + 2 * hq * hd * d
    ffn = 2 * d * f * _ffn_matrices(model)
    return attention_layers(model) * (attn + ffn)


def request_flops(model: Dict, prompt_len: int, gen_len: int) -> float:
    """Model flops of one request, unpadded: the prompt and the generated
    tokens but the last through every layer, causal attention over the
    context each token sees, and the head for each generated token."""
    tokens = prompt_len + gen_len - 1
    hq, hd = model["num_heads"], _hd(model)
    contexts = tokens * (tokens + 1) / 2  # token t attends t keys, t = 1..tokens
    attn_scores = 4 * hq * hd * contexts * attention_layers(model)
    head = 2 * model["d_model"] * model["vocab_size"] * gen_len
    return tokens * token_matmul_flops(model) + attn_scores + head
