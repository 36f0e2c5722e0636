"""End to end: the median of the same population as ``p95_ms``."""
from perfbench.lib import stats


def read(record):
    lat = [r.latency for r in record.counted()]
    return stats.as_ms(stats.percentile(lat, 50)) if lat else None
