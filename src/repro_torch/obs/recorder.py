"""Crash-dump flight recorder.

A bounded ring of recent structured events that the drivers note into
at coarse-grained points (dispatches, failures, retries, breaker
transitions, sheds), dumped to a JSON postmortem when something goes
wrong. Trigger sites, wired in the drivers:

- conservation-assert failure (``AsyncProxyServer.assert_conserved`` /
  ``ServerlessPlatform.assert_conserved``),
- drain timeout (stragglers cancelled at shutdown),
- circuit breaker opening.

Dumps are numbered sequentially (never timestamped — no wall-clock
reads, so FakeClock runs stay deterministic) and dumping never raises:
a postmortem writer that can crash the run it is documenting would be
worse than no postmortem.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Deque, List, Optional

DEFAULT_DUMP_DIR = os.path.join("experiments", "results", "obs")


class FlightRecorder:
    __slots__ = ("capacity", "out_dir", "dropped", "dumps", "_buf", "_seq")

    def __init__(self, capacity: int = 2048,
                 out_dir: str = DEFAULT_DUMP_DIR) -> None:
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.out_dir = out_dir
        self.dropped = 0
        self.dumps: List[str] = []
        self._buf: Deque[dict] = deque(maxlen=capacity)
        self._seq = 0

    # ------------------------------------------------------------- hot path
    def note(self, t: float, kind: str, **fields) -> None:
        """Record one structured event (fields must be JSON-friendly)."""
        buf = self._buf
        if len(buf) == self.capacity:
            self.dropped += 1
        fields["t"] = t
        fields["kind"] = kind
        buf.append(fields)

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[dict]:
        return list(self._buf)

    # ---------------------------------------------------------------- dump
    def dump(self, reason: str, now: float = 0.0,
             extra: Optional[dict] = None) -> Optional[str]:
        """Write the ring to a JSON postmortem; returns the path.

        Swallows I/O errors (returns None) — the recorder must never
        turn a diagnosed failure into a new one."""
        self._seq += 1
        safe = "".join(c if c.isalnum() or c in "-_" else "-" for c in reason)
        path = os.path.join(self.out_dir,
                            f"flightrec-{self._seq:03d}-{safe}.json")
        payload = {
            "reason": reason,
            "now": now,
            "dropped": self.dropped,
            "extra": extra or {},
            "events": list(self._buf),
        }
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            with open(path, "w") as fh:
                json.dump(payload, fh, sort_keys=True)
        except OSError:
            return None
        self.dumps.append(path)
        return path
