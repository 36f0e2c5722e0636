"""Kernel ``decode_attention.cu``: its launches' bound (max of operations over the
bf16 peak and bytes over the HBM bandwidth, at each launch's shapes) over
its device time, in the profiled slice of a traced run, in %."""
from perfbench.lib import trace


def read(record):
    return trace.roofline_share(record, "decode_attention")
