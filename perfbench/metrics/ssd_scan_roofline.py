"""Kernel ``ssd_scan.cu`` with grouped B and C (the hybrid family in Zamba2's
published layout): its launches' bound (max of operations over the bf16
peak and bytes over the HBM bandwidth, at each launch's shapes,
``hybrid_counts.ssd_cost``) over its device time, in the profiled slice of a
traced run, in %."""
from perfbench.lib import hybrid_counts


def read(record):
    return hybrid_counts.roofline_share(record, "ssd_scan")
