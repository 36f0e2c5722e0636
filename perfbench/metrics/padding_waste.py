"""Proxy -> engine buckets: the share of batch rows that were padding, over
the batches dispatched in the window, in % (the definition of
``summary()["padding_waste"]``: padded rows over bucket rows)."""


def read(record):
    batches = record.window_batches()
    rows = sum(b.bucket for b in batches)
    return 100.0 * sum(b.bucket - b.size for b in batches) / rows if rows else None
