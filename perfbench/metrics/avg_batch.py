"""Proxy: requests per batch over the batches dispatched in the window
(``AsyncProxyServer.summary()["avg_batch_size"]`` counts the same over the
whole run, the lead-in included)."""


def read(record):
    batches = record.window_batches()
    return sum(b.size for b in batches) / len(batches) if batches else None
