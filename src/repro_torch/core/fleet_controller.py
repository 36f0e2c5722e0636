"""Vectorised MLProxy control plane for fleet-scale deployments.

The counterpart of the JAX package's ``core/jax_controller.py``, with its
names, shapes and arithmetic, on torch tensors on an explicit device. A
cloud provider shipping MLProxy as part of its API gateway hosts thousands
of endpoints; one Python object per endpoint is fine at paper scale, but
at fleet scale the control decisions themselves become a throughput
problem. This module expresses the two MLProxy decision loops as pure
functions over struct-of-arrays state, so one call advances all endpoints:

* :func:`aimd_step` — Algorithm 2 for N endpoints (one vector update).
* :func:`timeout_step` — Algorithm 1's DTO/TO computation for N endpoints.
* latency statistics as fixed-size ring buffers per (endpoint, bucket) with
  a masked percentile — the Smart Monitor's sliding window, kept in device
  memory.

Every function returns a new state (it clones what it changes) and never
synchronises with the host. The state lives where :func:`init_fleet` puts
it; the index and observation tensors passed in go to the same device.
As in JAX, a ``record_*`` call that names one endpoint twice is not
defined for the ring writes (which write lands is unspecified); the
dispatch counters add up, as JAX's scatter-add does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FleetState:
    """Struct-of-arrays control state for N endpoints × B batch-size buckets.

    Shapes:
      max_bs:        (N,) float32 — AIMD batch-size state (raw, ≥ 1).
      ring:          (N, B, W) float32 — latency samples per bucket (NaN = empty).
      ring_pos:      (N, B) int32 — next write slot per ring.
      e2e_ring:      (N, We) float32 — end-to-end latency samples (NaN = empty).
      e2e_pos:       (N,) int32.
      to_count:      (N,) int32 — timeout dispatches this interval.
      disp_count:    (N,) int32 — total dispatches this interval.
    """

    max_bs: torch.Tensor
    ring: torch.Tensor
    ring_pos: torch.Tensor
    e2e_ring: torch.Tensor
    e2e_pos: torch.Tensor
    to_count: torch.Tensor
    disp_count: torch.Tensor


def init_fleet(n_endpoints: int, n_buckets: int, window: int = 64,
               e2e_window: int = 256, initial_max_bs: float = 1.0, *,
               device) -> FleetState:
    """Empty state for ``n_endpoints`` on ``device`` (``"cuda"`` for the
    card; a caller that wants the CPU names it): every later call keeps
    the state there."""
    f32, i32 = torch.float32, torch.int32
    return FleetState(
        max_bs=torch.full((n_endpoints,), initial_max_bs, dtype=f32, device=device),
        ring=torch.full((n_endpoints, n_buckets, window), float("nan"), dtype=f32,
                        device=device),
        ring_pos=torch.zeros((n_endpoints, n_buckets), dtype=i32, device=device),
        e2e_ring=torch.full((n_endpoints, e2e_window), float("nan"), dtype=f32,
                            device=device),
        e2e_pos=torch.zeros((n_endpoints,), dtype=i32, device=device),
        to_count=torch.zeros((n_endpoints,), dtype=i32, device=device),
        disp_count=torch.zeros((n_endpoints,), dtype=i32, device=device),
    )


def _masked_percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Percentile over the non-NaN entries of the trailing axis.

    Empty windows yield NaN (callers treat NaN as "no estimate"). A sort
    that puts NaN last (``torch.sort`` does, on the CPU and the card, as
    ``jnp.sort`` does) and a per-row nearest-rank gather, the rank computed
    in float32 as JAX computes it; no host sync.
    """
    sorted_x = torch.sort(x, dim=-1).values  # NaNs sort to the end
    count = (~torch.isnan(x)).sum(dim=-1, dtype=torch.int32)
    rank = torch.ceil(count.to(torch.float32) * (q / 100.0)).to(torch.int32) - 1
    rank = torch.clamp(rank, 0, x.shape[-1] - 1)
    picked = torch.gather(sorted_x, -1, rank[..., None].long())[..., 0]
    return torch.where(count > 0, picked, torch.full_like(picked, float("nan")))


def _on(state: FleetState, *xs):
    """Each of ``xs`` as a tensor on the state's device, floats in float32
    (as JAX, without x64, takes a float64 numpy array)."""
    out = [torch.as_tensor(x, device=state.max_bs.device) for x in xs]
    return [x.float() if x.is_floating_point() else x for x in out]


def record_upstream(state: FleetState, endpoint, bucket, latency,
                    percentile: float = 95.0) -> FleetState:
    """Scatter a batch of (endpoint, bucket, latency) observations.
    (``percentile`` is unused, as in JAX: kept for the same signature.)"""
    endpoint, bucket, latency = _on(state, endpoint, bucket, latency)
    endpoint, bucket = endpoint.long(), bucket.long()
    w = state.ring.shape[-1]
    pos = state.ring_pos[endpoint, bucket]
    ring = state.ring.clone()
    ring[endpoint, bucket, pos.long()] = latency.to(ring.dtype)
    ring_pos = state.ring_pos.clone()
    ring_pos[endpoint, bucket] = (pos + 1) % w
    return dataclasses.replace(state, ring=ring, ring_pos=ring_pos)


def record_e2e(state: FleetState, endpoint, latency) -> FleetState:
    endpoint, latency = _on(state, endpoint, latency)
    endpoint = endpoint.long()
    w = state.e2e_ring.shape[-1]
    pos = state.e2e_pos[endpoint]
    ring = state.e2e_ring.clone()
    ring[endpoint, pos.long()] = latency.to(ring.dtype)
    e2e_pos = state.e2e_pos.clone()
    e2e_pos[endpoint] = (pos + 1) % w
    return dataclasses.replace(state, e2e_ring=ring, e2e_pos=e2e_pos)


def record_dispatch(state: FleetState, endpoint, was_timeout) -> FleetState:
    endpoint, was_timeout = _on(state, endpoint, was_timeout)
    endpoint = endpoint.reshape(-1).long()
    ones = torch.ones(endpoint.shape, dtype=torch.int32, device=endpoint.device)
    disp = state.disp_count.index_put((endpoint,), ones, accumulate=True)
    was_timeout = torch.broadcast_to(was_timeout.to(torch.int32).reshape(-1), endpoint.shape)
    to = state.to_count.index_put((endpoint,), was_timeout, accumulate=True)
    return dataclasses.replace(state, disp_count=disp, to_count=to)


def timeout_step(state: FleetState, queue_len, frt, slo,
                 percentile: float = 95.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1's decision for all N endpoints at once.

    Args:
      queue_len: (N,) int32 current queue sizes (N_q).
      frt: (N,) seconds since each endpoint's oldest queued request.
      slo: (N,) SLO targets.
    Returns:
      (dispatch_now, timeout): (N,) bool — dispatch immediately;
      (N,) float — relative timeout for endpoints not dispatching now.
    """
    queue_len, frt, slo = _on(state, queue_len, frt, slo)
    n, b, _ = state.ring.shape
    # RT95 for batch one larger than the queue; bucket index clips at B-1.
    probe = torch.clamp(queue_len, 0, b - 1).long()
    rows = torch.arange(n, device=probe.device)
    est = _masked_percentile(state.ring[rows, probe, :], percentile)
    # Fallback for empty windows: max over *all* buckets' percentiles (a
    # conservative stand-in for the regression fallback; NaN → optimistic 0).
    per_bucket = _masked_percentile(state.ring, percentile)  # (N, B)
    neg_inf = torch.full_like(per_bucket, float("-inf"))
    fallback = torch.where(torch.isnan(per_bucket), neg_inf, per_bucket).amax(dim=-1)
    fallback = torch.where(torch.isfinite(fallback), fallback, torch.zeros_like(fallback))
    est = torch.where(torch.isnan(est), fallback, est)
    dto = slo - est
    to = dto - frt
    dispatch_now = (to <= 0.0) & (queue_len > 0)
    full = queue_len >= torch.clamp(torch.floor(state.max_bs), min=1.0)
    return dispatch_now | full, torch.clamp(to, min=0.0)


def aimd_step(state: FleetState, slo, *, to_thresh: float = 0.9,
              compliance_factor: float = 0.8, inc_step: float = 1.0,
              dec_mult: float = 0.8, max_cap: float = 256.0,
              percentile: float = 95.0) -> FleetState:
    """Algorithm 2 for all N endpoints (one update + interval reset)."""
    (slo,) = _on(state, slo)
    rt = _masked_percentile(state.e2e_ring, percentile)  # (N,)
    to_ratio = torch.where(
        state.disp_count > 0,
        state.to_count / torch.clamp(state.disp_count, min=1),
        torch.zeros((), dtype=torch.float32, device=rt.device))
    rt_violation = torch.where(torch.isnan(rt), False, rt > compliance_factor * slo)
    violation = (to_ratio > to_thresh) | rt_violation
    new_bs = torch.where(
        violation,
        torch.clamp(state.max_bs * dec_mult, min=1.0),
        torch.clamp(state.max_bs + inc_step, max=max_cap),
    )
    return dataclasses.replace(
        state,
        max_bs=new_bs,
        to_count=torch.zeros_like(state.to_count),
        disp_count=torch.zeros_like(state.disp_count),
    )


def effective_max_bs(state: FleetState) -> torch.Tensor:
    return torch.clamp(torch.floor(state.max_bs).to(torch.int32), min=1)
