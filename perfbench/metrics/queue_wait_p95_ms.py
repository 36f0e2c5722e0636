"""Proxy (``core/batch_queue.py``, ``monitor.py``, ``optimizer.py``,
``policies.py``): the 95th percentile over the window's dispatched
requests of dispatch time (the queue's stamp, read by the recording
target) minus due time, in ms."""
from perfbench.lib import stats


def read(record):
    waits = [r.dispatch - r.due for r in record.counted() if r.dispatch is not None]
    return 1e3 * stats.percentile(waits, 95) if waits else None
