"""The yardstick of the hybrid family in Zamba2's published layout: the
operations and bytes of each grouped SSD-scan launch and of each flash and
decode-attention launch of its shared blocks, the launches one batch
makes, and a served request's model flops. Counted from the configuration's
shapes alone, and frozen here (beside ``roofline.py``'s) so that a change
to the program cannot move the ruler it is measured with.

A launch's bound is ``roofline.bound_s``: the larger of its operations over
the bf16 peak and its bytes over the HBM bandwidth; each input byte is
counted read once and each output byte written once.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

from perfbench.lib import roofline, trace

BF16, F32 = 2, 4  # bytes an element
CONV_WIDTH = 4  # Mamba-2's causal conv


def _d_inner(model: Dict) -> int:
    return 2 * model["d_model"]


def ssm_heads(model: Dict) -> int:
    return _d_inner(model) // model["ssm_head_dim"]


def applications(model: Dict) -> int:
    """Shared-block applications a token passes: the hybrid layers."""
    return len(model["hybrid_layer_ids"])


# ------------------------------------------------------------ kernel launches
def ssd_cost(b: int, s: int, h: int, p: int, n: int, g: int, chunk: int
             ) -> Tuple[float, float]:
    """(bytes, flops) of one SSD-scan launch over (B, S) with H heads of
    head dim P, state N, B and C in G groups, chunks of ``chunk`` rows: x
    read and y written (bf16), dt (f32), B and C (bf16) and a (f32) read.
    Flops, per chunk of Q rows: C·Bᵀ once per group and w·x per head over
    the causal half, and the carried state's two products (C·hᵀ into every
    chunk but the first, the update out of every chunk but the last)."""
    nbytes = BF16 * 2 * b * s * h * p + F32 * b * s * h + BF16 * 2 * b * s * g * n + F32 * h
    flops = 0.0
    chunks = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    for i, q in enumerate(chunks):
        causal = q * (q + 1) / 2
        flops += 2 * b * causal * (n * g + p * h)
        if i > 0:
            flops += 2 * b * q * n * p * h
        if i < len(chunks) - 1:
            flops += 2 * b * q * n * p * h
    return nbytes, flops


def expected_launches(model: Dict, batch, gen_len: int) -> Dict[str, List[Tuple[float, float]]]:
    """Port kernel -> (bytes, flops) of each launch one batch makes: an SSD
    scan a Mamba layer and a flash launch a shared-block application at
    prefill, then a decode-attention launch an application at each of the
    ``gen_len - 1`` decode steps, over the cache rows written so far."""
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    apps, b, s = applications(model), batch.bucket, batch.plen
    ssd = ssd_cost(b, s, ssm_heads(model), model["ssm_head_dim"], model["ssm_state"],
                   model.get("ssm_groups", 1), min(model["ssm_chunk"], max(s, 8)))
    return {"ssd_scan": [ssd] * model["num_layers"],
            "flash_attention": [roofline.flash_cost(b, s, hq, hkv, hd)] * apps,
            "decode_attention": [roofline.decode_cost(b, s + i, hq, hkv, hd)
                                 for i in range(1, gen_len) for _ in range(apps)]}


def roofline_share(record, kernel: str) -> Optional[float]:
    """Σ bound over the kernel's launches in the traced slice / its device
    time, in %, as ``trace.roofline_share`` reads the dense family's: None
    where the run is of another family or layout, where the slice holds none
    of the kernel's launches, or fewer than its batches make (the profiler
    dropped records); raises where it holds more."""
    prof = record.profile
    if prof is None or not record.model.get("hybrid_layer_ids"):
        return None
    want: List[Tuple[float, float]] = []
    for b in prof.batches:
        want += expected_launches(record.model, b, record.mix["gen_len"])[kernel]
    seen = trace.device_time_by_kernel(prof).get(kernel)
    if not want or seen is None:
        return None
    if seen[0] > len(want):
        raise AssertionError(f"{kernel}: {seen[0]} launches in the slice, its batches make "
                             f"{len(want)}")
    if seen[0] < len(want):
        print(f"[trace] {kernel}: {seen[0]} of {len(want)} launches recorded; "
              "no roofline share read", file=sys.stderr)
        return None
    bound = sum(roofline.bound_s(nb, fl) for nb, fl in want)
    return 100.0 * bound / seen[1]


# ------------------------------------------------------------- model counts
def token_flops(model: Dict) -> float:
    """Flops of one token through every layer, without the attention
    scores and the head: each Mamba mixer's in_proj, causal conv, SSD step
    (the state update and its read-out, 4·H·P·N) and out_proj; each
    application's attention projections from the concatenated input, its
    gated MLP with the LoRA on gate_up, and its ``linear``."""
    d, f, di = model["d_model"], model["d_ff"], _d_inner(model)
    g, n, h = model.get("ssm_groups", 1), model["ssm_state"], ssm_heads(model)
    conv_dim = di + 2 * g * n
    mamba = (2 * d * (di + conv_dim + h) + 2 * CONV_WIDTH * conv_dim
             + 4 * h * model["ssm_head_dim"] * n + 2 * di * d)
    hq, hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    width, r = model["attention_hidden_size"], model["adapter_rank"]
    block = (2 * width * hd * (hq + 2 * hkv) + 2 * hq * hd * d
             + 2 * d * 2 * f + 2 * f * d + 2 * r * (d + 2 * f) + 2 * d * d)
    return model["num_layers"] * mamba + applications(model) * block


def request_flops(model: Dict, prompt_len: int, gen_len: int) -> float:
    """Model flops of one request, unpadded: the prompt and the generated
    tokens but the last through every layer, causal attention over the
    context each token sees at every application, and the head for each
    generated token."""
    tokens = prompt_len + gen_len - 1
    contexts = tokens * (tokens + 1) / 2
    attn_scores = 4 * model["num_heads"] * model["head_dim"] * contexts * applications(model)
    head = 2 * model["d_model"] * model["vocab_size"] * gen_len
    return tokens * token_flops(model) + attn_scores + head
