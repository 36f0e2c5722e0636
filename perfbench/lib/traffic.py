"""Open-loop traffic from a cell's parameters and a seed.

The arrival processes are copies of the port's Poisson and MMPP2
generators (``repro_torch/simulation/arrivals.py``: ``_poisson_window``
and ``MMPP2.next_arrivals``), frozen here so that a change to the program
cannot change the load it is measured under.

The arrival times are the cell's: drawn from ``SCHEDULE_SEED`` on a
stream of each phase's own (lead-in, window, tail), the same for every
run and every seed. A run's ``--seed`` draws the prompts, one per request from the
seed and the request's index, so every seed sends the same load, request
for request, with other prompts. (Shuffling the arrival gaps by the seed
instead moved starcoder2-instruct's p95 by 15% from seed to seed, and
tipped a burst cell into or out of a collapse of its batches.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

_EMPTY = np.empty(0, dtype=np.float64)

#: phases of a run's traffic, in order; each is drawn on a stream of its own
PHASES = ("lead_in", "window", "tail")

#: the seed of every cell's arrival times: a cell's rate and process fix them
SCHEDULE_SEED = 0


def _poisson_window(start: float, end: float, rate: float,
                    rng: np.random.Generator) -> np.ndarray:
    """All homogeneous-Poisson arrivals in ``(start, end]`` at ``rate``
    (a copy of the port's ``_poisson_window``)."""
    if rate <= 0 or end <= start:
        return _EMPTY
    chunks = []
    t = start
    while True:
        n = max(16, int(rate * (end - t) * 1.2) + 8)
        times = t + np.cumsum(rng.exponential(1.0 / rate, n))
        last = float(times[-1])
        if last > end:
            chunks.append(times[: int(np.searchsorted(times, end, side="right"))])
            break
        chunks.append(times)
        if last == end:
            break
        t = last
    return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)


def mmpp2_window(rate_lo: float, rate_hi: float, mean_lo: float, mean_hi: float,
                 duration: float, rng: np.random.Generator) -> np.ndarray:
    """All arrivals in ``[0, duration)`` of an MMPP2 process started in its
    low state (the port's ``MMPP2.next_arrivals`` over one window)."""
    out = []
    t, state, switch_at = 0.0, 0, None
    while t < duration:
        if switch_at is None:
            mean = mean_lo if state == 0 else mean_hi
            switch_at = t + rng.exponential(mean)
        rate = rate_lo if state == 0 else rate_hi
        seg_end = min(switch_at, duration)
        if rate > 0:
            out.append(_poisson_window(t, seg_end, rate, rng))
        if switch_at <= duration:
            t = switch_at
            state ^= 1
            switch_at = None
        else:
            t = duration
    times = np.concatenate(out) if out else _EMPTY
    return times[times < duration]


def phase_arrivals(arrivals: Dict, duration: float, phase: str) -> np.ndarray:
    """Arrival offsets in ``[0, duration)`` of one phase of every run."""
    rng = np.random.default_rng([SCHEDULE_SEED, PHASES.index(phase)])
    process = arrivals["process"]
    if process == "poisson":
        times = _poisson_window(0.0, duration, float(arrivals["rate"]), rng)
        return times[times < duration]
    if process == "mmpp2":
        mean = float(arrivals["rate"])
        return mmpp2_window(mean * float(arrivals["low_share"]),
                            mean * float(arrivals["high_share"]),
                            float(arrivals["mean_dwell_low_s"]),
                            float(arrivals["mean_dwell_high_s"]), duration, rng)
    raise ValueError(f"unknown arrival process {process!r}")


@dataclasses.dataclass
class Schedule:
    """Due times of one run, on a clock whose 0 is the start of the lead-in."""
    due: np.ndarray          # every request's due time, ascending
    window: Tuple[float, float]  # [open, close)

    def counted(self) -> np.ndarray:
        """Indices of the requests due inside the window."""
        lo, hi = self.window
        return np.nonzero((self.due >= lo) & (self.due < hi))[0]


def schedule(arrivals: Dict, lead_in_s: float, seconds: float, tail_s: float) -> Schedule:
    """The lead-in, the window and the tail after it, back to back."""
    parts, t0 = [], 0.0
    for phase, length in zip(PHASES, (lead_in_s, seconds, tail_s)):
        if length > 0:
            parts.append(t0 + phase_arrivals(arrivals, length, phase))
        t0 += length
    due = np.concatenate(parts) if parts else _EMPTY
    return Schedule(due=due, window=(lead_in_s, lead_in_s + seconds))


def prompt(seed: int, index: int, prompt_len: int, vocab: int) -> np.ndarray:
    """Request ``index``'s prompt: ``prompt_len`` token ids in ``[0, vocab)``."""
    rng = np.random.default_rng([seed, index, 2])
    return rng.integers(0, vocab, prompt_len).astype(np.int32)


def seed_key(seed: int) -> int:
    """A non-negative key for any whole-number seed (numpy and torch take it)."""
    return int(seed) % (1 << 63)
