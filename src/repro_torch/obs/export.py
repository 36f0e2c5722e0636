"""Span reconstruction and exporters for tracer event streams.

Two artifacts per the observability plan:

- Chrome ``trace_event`` JSON (:func:`chrome_trace` /
  :func:`write_chrome_trace`): open in ``chrome://tracing`` or
  https://ui.perfetto.dev. Requests render as one lane per request
  (queue slice + service slice); batches render on their own lanes with
  instant markers for retries, hedges, faults and breaker waits.
- Flat per-request CSV (:func:`write_request_csv`): one row per request
  with the budget breakdown — queue wait (admission→batch formation),
  service (dispatch→resolution), retry overhead (sum of retry backoffs
  charged to the batch), breaker wait, and the terminal outcome.

Reconstruction is a single pass over the flat event tuples; no state is
kept in the hot path. All timestamps are whatever clock domain the
tracer saw (sim seconds or FakeClock seconds); Chrome expects
microseconds, so export multiplies by 1e6.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List

from repro_torch.obs.trace import (EV_BATCH, EV_DETAIL, EV_ENDPOINT, EV_KIND,
                             EV_REQ, EV_SIZE, EV_T, EV_VALUE, TraceTuple)

_TERMINAL_BATCH = ("completed", "timed_out", "failed")
_TERMINAL_REQ = ("expired", "shed", "rejected")
#: Kinds whose value slot carries the request's queue-entry arrival time
#: ("batched" carries a tuple of them and is unpacked separately).
_QUEUE_ANCHORED = ("expired", "shed")


def build_batch_spans(events: List[TraceTuple]) -> Dict[int, dict]:
    """Fold batch-scoped events into one record per batch id."""
    batches: Dict[int, dict] = {}
    for ev in events:
        bid = ev[EV_BATCH]
        if bid < 0:
            continue
        rec = batches.get(bid)
        if rec is None:
            rec = batches[bid] = {
                "batch": bid, "endpoint": ev[EV_ENDPOINT], "dispatched": None,
                "end": None, "outcome": None, "size": 0, "cause": "",
                "retries": 0, "hedges": 0, "faults": 0, "attempts": 0,
                "retry_overhead": 0.0, "breaker_wait": 0.0, "members": [],
            }
        kind = ev[EV_KIND]
        if kind == "dispatched":
            rec["dispatched"] = ev[EV_T]
            rec["size"] = ev[EV_SIZE]
            rec["cause"] = ev[EV_DETAIL]
            if ev[EV_ENDPOINT]:
                rec["endpoint"] = ev[EV_ENDPOINT]
        elif kind == "batched":
            # columnar membership event: req slot is the member-id tuple
            rec["members"].extend(ev[EV_REQ])
        elif kind == "retry":
            rec["retries"] += 1
            rec["retry_overhead"] += ev[EV_VALUE]
        elif kind == "hedge":
            rec["hedges"] += 1
        elif kind == "fault":
            rec["faults"] += 1
        elif kind == "attempt":
            rec["attempts"] += 1
        elif kind == "breaker_wait":
            rec["breaker_wait"] += ev[EV_VALUE]
        elif kind in _TERMINAL_BATCH:
            rec["end"] = ev[EV_T]
            rec["outcome"] = kind
    return batches


def build_request_spans(events: List[TraceTuple]) -> List[dict]:
    """One record per request with the per-stage budget breakdown.

    ``queue_wait`` runs from queue entry to batch formation; the
    queue-entry instant is the ``admitted`` timestamp when a frontend is
    in the loop, else the arrival time the resolving ``batched`` /
    ``expired`` / ``shed`` event carries in its value slot (there is no
    per-arrival event on the hot path). ``service`` runs from batch
    dispatch to batch resolution and includes any retries —
    ``retry_overhead``/``breaker_wait`` say how much of it was spent
    re-trying rather than serving.
    """
    batches = build_batch_spans(events)
    reqs: Dict[int, dict] = {}
    for ev in events:
        kind = ev[EV_KIND]
        if kind == "batched":
            # columnar membership event: fan the member-id / arrival
            # tuples back out into one record per member
            t, bid, endpoint = ev[EV_T], ev[EV_BATCH], ev[EV_ENDPOINT]
            for rid, arrival in zip(ev[EV_REQ], ev[EV_VALUE]):
                rec = reqs.get(rid)
                if rec is None:
                    rec = reqs[rid] = {
                        "req_id": rid, "endpoint": endpoint,
                        "start": t, "batched": None,
                        "batch": -1, "end": None, "outcome": None,
                    }
                elif endpoint and not rec["endpoint"]:
                    rec["endpoint"] = endpoint
                rec["batched"] = t
                rec["batch"] = bid
                if 0.0 < arrival < rec["start"]:
                    rec["start"] = arrival
            continue
        rid = ev[EV_REQ]
        if rid < 0:
            continue
        rec = reqs.get(rid)
        if rec is None:
            rec = reqs[rid] = {
                "req_id": rid, "endpoint": ev[EV_ENDPOINT],
                "start": ev[EV_T], "batched": None,
                "batch": -1, "end": None, "outcome": None,
            }
        if ev[EV_ENDPOINT] and not rec["endpoint"]:
            rec["endpoint"] = ev[EV_ENDPOINT]
        if kind in _TERMINAL_REQ:
            rec["end"] = ev[EV_T]
            rec["outcome"] = kind
        if kind in _QUEUE_ANCHORED:
            # value is the queue-entry arrival time (0.0 when the
            # emitter did not know it, e.g. a submit-time brownout drop)
            v = ev[EV_VALUE]
            if 0.0 < v < rec["start"]:
                rec["start"] = v

    rows: List[dict] = []
    for rid in sorted(reqs):
        rec = reqs[rid]
        batch = batches.get(rec["batch"])
        end = rec["end"]
        outcome = rec["outcome"]
        if batch is not None and outcome is None:
            end = batch["end"]
            outcome = batch["outcome"]
        queue_end = rec["batched"] if rec["batched"] is not None else end
        queue_wait = (queue_end - rec["start"]
                      if queue_end is not None else None)
        service = None
        if batch is not None and batch["dispatched"] is not None \
                and batch["end"] is not None:
            service = batch["end"] - batch["dispatched"]
        rows.append({
            "req_id": rid,
            "endpoint": rec["endpoint"],
            "arrival": rec["start"],
            "queue_wait": queue_wait,
            "service": service,
            "e2e": (end - rec["start"]) if end is not None else None,
            "outcome": outcome or "inflight",
            "batch": rec["batch"],
            "batch_size": batch["size"] if batch else 0,
            "retries": batch["retries"] if batch else 0,
            "hedges": batch["hedges"] if batch else 0,
            "retry_overhead": batch["retry_overhead"] if batch else 0.0,
            "breaker_wait": batch["breaker_wait"] if batch else 0.0,
        })
    return rows


# ------------------------------------------------------------------ chrome
def chrome_trace(events: List[TraceTuple]) -> dict:
    """Chrome ``trace_event`` document (the JSON Object Format).

    pid 1 = request lanes, pid 2 = batch lanes. Durations use "X"
    complete events; point-in-time markers (faults, retries, hedges,
    breaker transitions) use "i" instant events. Timestamps are
    microseconds per the trace_event spec.
    """
    out: List[dict] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "requests"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "batches"}},
    ]
    us = 1e6
    for row in build_request_spans(events):
        tid = row["req_id"]
        t0 = row["arrival"] * us
        if row["queue_wait"] is not None:
            out.append({"ph": "X", "pid": 1, "tid": tid, "name": "queue",
                        "cat": "request", "ts": t0,
                        "dur": row["queue_wait"] * us,
                        "args": {"endpoint": row["endpoint"],
                                 "outcome": row["outcome"]}})
        if row["service"] is not None and row["queue_wait"] is not None:
            out.append({"ph": "X", "pid": 1, "tid": tid, "name": "service",
                        "cat": "request",
                        "ts": t0 + row["queue_wait"] * us,
                        "dur": row["service"] * us,
                        "args": {"batch": row["batch"],
                                 "retries": row["retries"]}})
    for bid in sorted(b := build_batch_spans(events)):
        rec = b[bid]
        if rec["dispatched"] is None:
            continue
        dur = ((rec["end"] - rec["dispatched"]) * us
               if rec["end"] is not None else 0.0)
        out.append({"ph": "X", "pid": 2, "tid": bid,
                    "name": f"batch[{rec['size']}] {rec['cause']}",
                    "cat": "batch", "ts": rec["dispatched"] * us, "dur": dur,
                    "args": {"endpoint": rec["endpoint"],
                             "outcome": rec["outcome"],
                             "retries": rec["retries"],
                             "members": rec["members"]}})
    for ev in events:
        if ev[EV_KIND] in ("fault", "retry", "hedge", "breaker_wait",
                           "breaker_open", "rejected", "shed", "expired"):
            out.append({"ph": "i", "pid": 2,
                        "tid": ev[EV_BATCH] if ev[EV_BATCH] >= 0 else 0,
                        "name": ev[EV_KIND], "cat": "event", "s": "g",
                        "ts": ev[EV_T] * us,
                        "args": {"endpoint": ev[EV_ENDPOINT],
                                 "detail": ev[EV_DETAIL],
                                 "value": ev[EV_VALUE]}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ------------------------------------------------------------------ writers
REQUEST_CSV_FIELDS = ("req_id", "endpoint", "arrival", "queue_wait",
                      "service", "e2e", "outcome", "batch", "batch_size",
                      "retries", "hedges", "retry_overhead", "breaker_wait")


def write_chrome_trace(path: str, events: List[TraceTuple]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(chrome_trace(events), fh, sort_keys=True)
    return path


def write_request_csv(path: str, events: List[TraceTuple]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=REQUEST_CSV_FIELDS)
        w.writeheader()
        for row in build_request_spans(events):
            w.writerow(row)
    return path
