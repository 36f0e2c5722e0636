"""Model step (the engine's graphs over ``models/*``): model flops of the
real (unpadded) prompt and generated tokens of the batches dispatched in
the window, counted from the configuration's shapes, over the engine's
``latency_s`` of those batches times the bf16 peak, in %."""
from perfbench.lib import roofline


def read(record):
    batches = record.window_batches()
    seconds = sum(b.latency_s for b in batches)
    if not seconds:
        return None
    mix = record.mix
    flops = sum(b.size for b in batches) * roofline.request_flops(
        record.model, mix["prompt_len"], mix["gen_len"])
    return 100.0 * flops / (seconds * roofline.PEAK_FLOPS_BF16)
