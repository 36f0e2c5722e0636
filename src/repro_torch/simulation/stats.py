"""Growable numeric buffers for the simulator's metrics hot path.

The event core used to keep ``List[Request]`` plus per-sample rebuilt
Python lists and re-ran ``np.percentile`` over them; at millions of
requests those scans dominate the run. These helpers keep everything in
amortized-O(1)-append float64 storage that exposes zero-copy views for
vectorized reductions at sample/result time.
"""
from __future__ import annotations

import numpy as np


class FloatBuffer:
    """Amortized-O(1) append float64 buffer with a zero-copy view."""

    __slots__ = ("_arr", "_n")

    def __init__(self, capacity: int = 1024) -> None:
        self._arr = np.empty(max(1, capacity), dtype=np.float64)
        self._n = 0

    def append(self, x: float) -> None:
        arr = self._arr
        n = self._n
        if n == arr.shape[0]:
            grown = np.empty(2 * n, dtype=np.float64)
            grown[:n] = arr
            self._arr = arr = grown
        arr[n] = x
        self._n = n + 1

    def __len__(self) -> int:
        return self._n

    def view(self) -> np.ndarray:
        """Zero-copy view of the filled prefix (invalidated by append)."""
        return self._arr[: self._n]


class CompletionLog:
    """Per-completion record of (completion time, e2e latency, arrival time).

    Completion times are appended in event order, hence non-decreasing —
    which makes the trailing-window query a binary search instead of the
    deque-prune-plus-rebuild the sampler used to do.
    """

    __slots__ = ("t_done", "e2e", "arrival")

    def __init__(self) -> None:
        self.t_done = FloatBuffer()
        self.e2e = FloatBuffer()
        self.arrival = FloatBuffer()

    def append(self, t_done: float, e2e: float, arrival: float) -> None:
        self.t_done.append(t_done)
        self.e2e.append(e2e)
        self.arrival.append(arrival)

    def __len__(self) -> int:
        return len(self.e2e)

    def window(self, cutoff: float) -> np.ndarray:
        """Latencies of completions with ``t_done >= cutoff`` (zero-copy)."""
        t = self.t_done.view()
        return self.e2e.view()[int(np.searchsorted(t, cutoff, side="left")):]
