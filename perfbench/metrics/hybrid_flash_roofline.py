"""Kernel ``flash_attention.cu`` in the shared blocks of the hybrid family in
Zamba2's published layout (head dim 224, one launch an application at
prefill): its launches' bound over its device time, in the profiled slice of
a traced run, in %."""
from perfbench.lib import hybrid_counts


def read(record):
    return hybrid_counts.roofline_share(record, "flash_attention")
