"""Reading the profiled slice of a traced run.

The slice holds whole batches (the recording target starts and stops the
profiler between two batches: from the window's last ``profile_slice_s``
until its last request is resolved), so every port-kernel launch in it
belongs to a batch whose shapes are known: the batch bucket, the prompt bucket,
the generated length. Each launch's bound comes from those shapes through
the frozen counts in :mod:`perfbench.lib.roofline`; its time from the
trace, by kernel name (``chip_smoke.py``'s ``profiled_kernels`` pattern).
"""
from __future__ import annotations

import collections
import sys
from typing import Dict, List, Optional, Tuple

from perfbench.lib import roofline

NO_HOST_OP = "no torch op on the host (proxy, queue, Python)"


def kernels(profile) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of every device kernel in the slice."""
    return [(name, s, e) for name, dev, s, e in profile.events if dev]


def busy_s(profile) -> Optional[float]:
    ks = kernels(profile)
    if not ks:
        return None
    return roofline.union_length((s, e) for _, s, e in ks) / 1e6


def device_time_by_kernel(profile) -> Dict[str, Tuple[int, float]]:
    """Port kernel -> (launches seen, device seconds)."""
    out: Dict[str, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in kernels(profile):
        k = roofline.port_kernel(name)
        if k:
            out[k][0] += 1
            out[k][1] += (e - s) / 1e6
    return {k: (int(n), t) for k, (n, t) in out.items()}


def expected_launches(model: Dict, batch, gen_len: int) -> Dict[str, List[Tuple[float, float]]]:
    """Port kernel -> (bytes, flops) of each launch one batch makes."""
    hq, hkv = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // hq
    apps = roofline.attention_layers(model)
    b, s = batch.bucket, batch.plen
    return {"flash_attention": [roofline.flash_cost(b, s, hq, hkv, hd)] * apps,
            "decode_attention": [roofline.decode_cost(b, s + i, hq, hkv, hd)
                                 for i in range(1, gen_len) for _ in range(apps)]}


def roofline_share(record, kernel: str) -> Optional[float]:
    """Σ bound over the kernel's launches in the slice / its device time,
    in %. None where the slice holds none of its launches, or fewer than its
    batches make: the profiler dropped kernel records (its activity buffers
    can overflow), and the launches it kept are no fair sample of the rest,
    since a decode launch's work grows with its cache. Raises where the
    trace holds more launches than the batches make: the bound would then be
    counted for the wrong work."""
    prof = record.profile
    if prof is None:
        return None
    want: List[Tuple[float, float]] = []
    for b in prof.batches:
        want += expected_launches(record.model, b, record.mix["gen_len"]).get(kernel, [])
    seen = device_time_by_kernel(prof).get(kernel)
    if not want or seen is None:
        return None
    if seen[0] > len(want):
        raise AssertionError(f"{kernel}: {seen[0]} launches in the slice, its batches make "
                             f"{len(want)}")
    if seen[0] < len(want):
        print(f"[trace] {kernel}: {seen[0]} of {len(want)} launches recorded; "
              "no roofline share read", file=sys.stderr)
        return None
    bound = sum(roofline.bound_s(nb, fl) for nb, fl in want)
    return 100.0 * bound / seen[1]


def breakdown(profile, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle gaps
    of the slice, each named by the host op running at its middle."""
    ks = kernels(profile)
    by_name: Dict[str, float] = collections.Counter()
    for name, s, e in ks:
        by_name[name[:160]] += (e - s) / 1e6
    ops = [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
    merged: List[List[float]] = []
    for s, e in sorted((s, e) for _, s, e in ks):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:])),
                  reverse=True)[:top]
    host = [(name, s, e) for name, dev, s, e in profile.events if not dev]
    named = []
    for length, a, b in gaps:
        mid = (a + b) / 2
        inside = [(e - s, n) for n, s, e in host if s <= mid <= e]
        named.append([min(inside)[1][:160] if inside else NO_HOST_OP, length / 1e6])
    return {"device_ops": ops, "idle_gaps": named}
