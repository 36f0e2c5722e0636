"""Runtime event loop (``runtime/server.py``): how late the open-loop
generator submitted, the 95th percentile over the window's requests of
submit time minus due time, in ms."""
from perfbench.lib import stats


def read(record):
    lags = [r.submit - r.due for r in record.counted() if r.submit is not None]
    return 1e3 * stats.percentile(lags, 95) if lags else None
