"""Runtime dispatch (``runtime/targets.py``, ``serving/batcher.py``, the
pool's lock): per batch dispatched in the window, the server's measured
await time (dispatch to completion, what it records in
``bucket_samples``) minus the engine's own ``latency_s`` (and minus the
time a traced run's recording target spent starting or stopping the
profiler in it); the mean, in ms."""


def read(record):
    done = {r.req_id: r.complete for r in record.requests if r.complete is not None}
    gaps = [done[b.req_ids[0]] - b.dispatch - b.latency_s - b.overhead_s
            for b in record.window_batches() if b.req_ids[0] in done]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
