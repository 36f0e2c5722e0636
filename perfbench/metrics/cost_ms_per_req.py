"""End to end: what a serverless platform bills a request, the paper's
cost. Each batch's engine time (``timing["latency_s"]`` of
``InferenceEngine.generate``, lock waits not included) is shared equally
by its requests; the mean share over the window's completed requests, in
ms."""


def read(record):
    share = {}
    for b in record.batches:
        for rid in b.req_ids:
            share[rid] = b.latency_s / b.size
    costs = [share[r.req_id] for r in record.counted() if r.req_id in share]
    return 1e3 * sum(costs) / len(costs) if costs else None
