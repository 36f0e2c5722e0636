"""Device (H100): the share of the profiled slice in which no kernel ran,
1 - (union of kernel intervals) / the slice's length, in %."""
from perfbench.lib import trace


def read(record):
    if record.profile is None:
        return None
    busy = trace.busy_s(record.profile)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / record.profile.window_s)
