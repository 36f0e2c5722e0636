"""Glue between the MLProxy control plane and the PyTorch engine.

``ReplicaPoolTarget`` is the real-serving dispatch target: it adapts a
:class:`~repro_torch.serving.engine.ReplicaPool` to the
``dispatch_fn(batch)`` contract of the shared
:class:`~repro_torch.core.batch_queue.BatchQueue`, so a policy dispatches
straight onto the card. (The JAX package's ``EngineBackedLatency`` waits
for the slice that ports the simulator and the serverless platform.)
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.core.request import Batch
from repro_torch.serving.engine import ReplicaPool, wall_clock


class ReplicaPoolTarget:
    """Per-endpoint dispatch target backed by a :class:`ReplicaPool`.

    Callable with the ``dispatch_fn(batch)`` signature the shared
    ``BatchQueue`` expects: builds the prompt array from each request's
    payload (token-id arrays; missing payloads become zero prompts), runs
    the pool with round-robin failover, and reports the measured wall-clock
    back through ``on_done(batch, latency_s, now)`` — typically the owning
    policy's ``on_response`` — closing the monitor feedback loop on real
    hardware.

    ``deadline`` (absolute, on this target's ``clock``) bounds the chunked
    path: once it has passed, remaining chunks are aborted — their
    requests are marked ``timed_out`` with no payload and counted in
    ``timing["deadline_aborted"]`` — instead of burning engine time on
    work nobody is waiting for. The chunk already running is never
    interrupted.
    """

    def __init__(self, pool: ReplicaPool, prompt_len: int = 16,
                 gen_len: Optional[int] = None,
                 on_done: Optional[Callable[[Batch, float, float], None]] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.pool = pool
        self.prompt_len = prompt_len
        self.gen_len = gen_len
        self.on_done = on_done
        # measurement clock; any deadline passed to __call__ must be
        # absolute on THIS clock
        self.clock = clock if clock is not None else wall_clock
        self.batches = 0
        self.requests = 0
        #: requests whose chunk was never executed because the batch
        #: deadline passed mid-way through the chunked path
        self.deadline_aborted = 0

    def _prompts(self, batch: Batch) -> np.ndarray:
        prompts = np.zeros((batch.size, self.prompt_len), np.int32)
        for i, req in enumerate(batch.requests):
            if req.payload is None:
                continue
            # keep the LAST prompt_len tokens: with left-padding the engine
            # continues from the trailing context, not the prompt's head
            toks = np.asarray(req.payload, np.int32).ravel()[-self.prompt_len:]
            prompts[i, self.prompt_len - len(toks):] = toks  # left-pad
        return prompts

    def __call__(self, batch: Batch, deadline: Optional[float] = None):
        t0 = self.clock()
        prompts = self._prompts(batch)
        largest = self.pool.engine_cfg.batch_buckets[-1]
        aborted_from: Optional[int] = None
        if batch.size <= largest:
            out, timing = self.pool.generate(prompts, gen_len=self.gen_len)
        else:
            # A batch larger than the largest bucket executes as sequential
            # largest-bucket chunks — the dispatch path never raises on a
            # policy whose cap outruns the engine's buckets.
            outs = []
            timing = None
            chunks = 0
            for lo in range(0, batch.size, largest):
                if (deadline is not None and lo > 0
                        and self.clock() >= deadline):
                    aborted_from = lo
                    break
                o, timing = self.pool.generate(prompts[lo:lo + largest],
                                               gen_len=self.gen_len)
                outs.append(o)
                chunks += 1
            out = np.concatenate(outs, axis=0)
            if out.shape[0] < batch.size:  # aborted tail: zero rows
                pad = np.zeros((batch.size - out.shape[0],) + out.shape[1:],
                               out.dtype)
                out = np.concatenate([out, pad], axis=0)
            timing = dict(timing)
            timing["chunks"] = chunks
        latency = self.clock() - t0
        self.batches += 1
        self.requests += batch.size
        if aborted_from is not None:
            timing["deadline_aborted"] = batch.size - aborted_from
            self.deadline_aborted += batch.size - aborted_from
        for i, (req, tokens) in enumerate(zip(batch.requests, out)):
            if aborted_from is not None and i >= aborted_from:
                req.timed_out = True  # partial batch: tail reported dead
            else:
                req.payload = tokens
        if self.on_done is not None:
            self.on_done(batch, latency, t0 + latency)
        return out, timing
