"""Model step of the hybrid family in Zamba2's published layout (the
engine's graphs over ``models/hybrid.py`` and ``models/ssm.py``): model
flops of the real (unpadded) prompt and generated tokens of the batches
dispatched in the window (``hybrid_counts.request_flops``: the Mamba mixers
and their SSD, the shared blocks with their LoRA and ``linear``, the
attention scores and the head), over the engine's ``latency_s`` of those
batches times the bf16 peak, in %."""
from perfbench.lib import hybrid_counts, roofline


def read(record):
    if not record.model.get("hybrid_layer_ids"):
        return None
    batches = record.window_batches()
    seconds = sum(b.latency_s for b in batches)
    if not seconds:
        return None
    mix = record.mix
    flops = sum(b.size for b in batches) * hybrid_counts.request_flops(
        record.model, mix["prompt_len"], mix["gen_len"])
    return 100.0 * flops / (seconds * roofline.PEAK_FLOPS_BF16)
