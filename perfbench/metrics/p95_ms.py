"""End to end: the 95th percentile of latency, from due time to completion,
over every request due in the window; a failed or unfinished request
counts as +inf (written as ``stats.FAILED_MS``)."""
from perfbench.lib import stats


def read(record):
    lat = [r.latency for r in record.counted()]
    return stats.as_ms(stats.percentile(lat, 95)) if lat else None
