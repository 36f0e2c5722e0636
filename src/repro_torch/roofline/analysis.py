"""Roofline analysis from the port's dry-run records.

Three terms per (arch × shape) cell on the single-pod mesh, all from
per-device quantities of the step (``launch/dryrun.py`` divides the meta
run's FLOPs and bytes by the device count and takes the collective census
per device), so each term divides by one GPU's peak:

    compute term    = FLOPs_per_device / peak_FLOPs
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / collective_bw

FLOPs, bytes and collective volumes come from the *depth-calibrated*
linear fit (two unrolled depths; ``launch/dryrun.py::calibrate_cell``),
as in the JAX package; the direct full-depth count is kept beside it.

Hardware constants, NVIDIA's published figures for the H100 SXM (dense,
no sparsity, at the 700 W limit): 989 TFLOP/s bf16 (``PEAK_FLOPS``),
3.35 TB/s HBM3 (``HBM_BW``), and 50 GB/s a GPU for collectives
(``COLLECTIVE_BW``): one 400 Gb/s NDR InfiniBand port a GPU, because each
16-wide mesh axis leaves the 8-GPU NVLink domain (450 GB/s a GPU each way
within it). These are host-computed figures, not times
measured on a card.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Any, Dict, List, Optional

PEAK_FLOPS = 989e12  # bf16 dense / GPU
HBM_BW = 3.35e12  # bytes/s / GPU
COLLECTIVE_BW = 50e9  # bytes/s / GPU across nodes (NDR 400 Gb/s)

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "artifacts",
    "dryrun_torch")

# Shape-cell step counts for MODEL_FLOPS (tokens processed by one step)
_TRAIN_MULT = 6.0  # fwd 2ND + bwd 4ND
_INFER_MULT = 2.0  # fwd only


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    status: str
    devices: int = 0
    flops: float = 0.0  # per device, calibrated
    bytes_hbm: float = 0.0
    bytes_coll: float = 0.0
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0  # analytic 6·N·D (per device)
    useful_ratio: float = 0.0  # model_flops / counted flops
    raw_flops: float = 0.0  # direct full-depth count
    skip_reason: Optional[str] = None
    memory: Optional[dict] = None
    compile_s: float = 0.0

    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)


def _extrapolate(points: List[dict], full_depth: int, key) -> float:
    """Linear fit through two depth points, evaluated at full depth."""
    (d1, v1), (d2, v2) = [(pt["depth"], key(pt)) for pt in points]
    if d2 == d1:
        return v2
    slope = (v2 - v1) / (d2 - d1)
    return v1 + slope * (full_depth - d1)


def tokens_of_shape(shape_name: str) -> float:
    from repro_torch.configs.base import SHAPES_BY_NAME

    s = SHAPES_BY_NAME[shape_name]
    if s.kind == "decode":
        return float(s.global_batch)  # one token per sequence
    return float(s.global_batch * s.seq_len)


def analyze_record(rec: Dict[str, Any]) -> RooflineRow:
    from repro_torch.configs import get_config

    row = RooflineRow(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                      status=rec.get("status", "?"),
                      skip_reason=rec.get("skip_reason"))
    if row.status != "ok":
        return row
    row.devices = rec.get("devices", 0)
    row.memory = rec.get("memory_analysis")
    row.compile_s = rec.get("lower_s", 0.0)
    row.raw_flops = rec.get("cost_analysis", {}).get("flops", 0.0)

    cal = rec.get("calibration")
    if cal and "points" in cal and len(cal["points"]) == 2:
        full = cal["full_depth"]
        row.flops = _extrapolate(cal["points"], full,
                                 lambda p: p["cost"].get("flops", 0.0))
        row.bytes_hbm = _extrapolate(cal["points"], full,
                                     lambda p: p["cost"].get("bytes accessed", 0.0))
        row.bytes_coll = _extrapolate(cal["points"], full,
                                      lambda p: p["collective_total_bytes"])
    else:
        row.flops = row.raw_flops
        row.bytes_hbm = rec.get("cost_analysis", {}).get("bytes accessed", 0.0)
        row.bytes_coll = rec.get("collectives", {}).get("total_bytes", 0.0)

    row.t_compute = row.flops / PEAK_FLOPS
    row.t_memory = row.bytes_hbm / HBM_BW
    row.t_collective = row.bytes_coll / COLLECTIVE_BW
    row.bottleneck = row.dominant()

    # analytic MODEL_FLOPS per device
    cfg = get_config(rec["arch"])
    n = cfg.active_param_count()
    mult = _TRAIN_MULT if rec.get("kind") == "train" else _INFER_MULT
    tokens = tokens_of_shape(rec["shape"])
    row.model_flops = mult * n * tokens / max(row.devices, 1)
    row.useful_ratio = row.model_flops / row.flops if row.flops else 0.0
    return row


def load_records(mesh: str = "pod1", artifact_dir: Optional[str] = None,
                 ) -> List[Dict[str, Any]]:
    d = artifact_dir or ARTIFACT_DIR
    recs = []
    for path in sorted(glob.glob(os.path.join(d, f"*__{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_table(mesh: str = "pod1", artifact_dir: Optional[str] = None,
                   ) -> List[RooflineRow]:
    return [analyze_record(r) for r in load_records(mesh, artifact_dir)]


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'status':8s} "
           f"{'compute(ms)':>12s} {'memory(ms)':>11s} {'collective(ms)':>14s} "
           f"{'bottleneck':>11s} {'useful':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.status != "ok":
            lines.append(f"{r.arch:24s} {r.shape:12s} {'SKIP':8s} "
                         f"{'—':>12s} {'—':>11s} {'—':>14s} "
                         f"{(r.skip_reason or ''):>11s}")
            continue
        lines.append(
            f"{r.arch:24s} {r.shape:12s} {r.status:8s} "
            f"{r.t_compute*1e3:12.2f} {r.t_memory*1e3:11.2f} "
            f"{r.t_collective*1e3:14.2f} {r.bottleneck:>11s} "
            f"{r.useful_ratio:7.2f}")
    return "\n".join(lines)


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mesh", default="pod1")
    p.add_argument("--json", action="store_true")
    args = p.parse_args()
    rows = roofline_table(args.mesh)
    if args.json:
        print(json.dumps([dataclasses.asdict(r) for r in rows], indent=1))
    else:
        print(format_table(rows))


if __name__ == "__main__":
    main()
