"""Meta-device dry-run: per-device bytes, FLOPs and collectives of every cell.

    python -m repro_torch.launch.dryrun --arch ID|all --shape NAME|all \\
        [--multi-pod | --both-meshes | --mesh-shape 4,4] [--no-save] [--no-calibrate]

For every (architecture × input shape × mesh) it builds the train, prefill
or decode step on meta tensors (``Model.init_abstract``, ``input_specs``:
shapes and dtypes, nothing allocated), lays every argument out by the
sharding rules of ``distributed/sharding.py`` on a ``DeviceMesh`` of the
mesh's size, and records, in the JAX package's record schema
(``src/repro/launch/dryrun.py``):

* ``memory_analysis.argument_size_in_bytes`` — exact: the sum over the
  step's arguments (params, AdamW state and batch; or params, tokens and
  cache) of each leaf's local block on one device. AdamW keeps bf16
  moments above 1e11 parameters, as JAX's dry-run does.
  ``output_size_in_bytes`` the same over the step's outputs.
* ``cost_analysis`` — per device: ``flops`` from
  ``torch.utils.flop_counter.FlopCounterMode`` over the step run on meta
  (matmuls, attention and convolutions; elementwise work is not counted),
  and ``bytes accessed``, every non-view aten op's inputs read and outputs
  written once (unfused), both divided by the device count. Attention, the
  mLSTM and the SSD scan count as their plain versions compute them (the
  full score matrix, written out), which the card's kernels do not.
* ``calibration`` — the same two counts at the two unrolled depths of
  :func:`calibration_depths`, as the JAX package fits them (XLA's cost
  analysis counts a scanned body once); ``cost_analysis`` is then their
  fit at full depth, which ``roofline/analysis.py`` also takes. The fit is
  exact where layers are homogeneous in their repeat unit, and it keeps a
  deep model's meta run short (the sLSTM steps one token at a time).
  ``--no-calibrate`` counts the step once at full depth instead.
* ``collectives`` — a census derived leaf by leaf from the plan, per
  device, in bytes of each collective's output (as the JAX package's
  ``collective_bytes`` sums them from compiled HLO, which the port cannot
  do, having no compiler that partitions the step):

  - **FSDP**: an all-gather over "data" of every parameter split on
    "data" (its block times the "data" size) for the forward; for train a
    second one for the backward and a reduce-scatter of its gradient (its
    block), and an all-reduce of every gradient over the DP axes it is not
    split on;
  - **tensor parallel**: an all-reduce over "model" of each out-projection
    output (``wo``/``out_proj``/``down_proj`` whose contracting dim is on
    "model"): the step's tokens on one device × its output width, once a
    stacked layer (the hybrid shared block once an application, encoder
    layers only where the encoder runs); train adds one for the
    backward, and one more for the recompute under ``remat``;
  - **the MoE plans** (``models/moe.py::choose_plan`` picks as JAX picks):
    token-route gathers the tokens over DP and all-reduces T × D;
    weight-gather gathers the rank's expert F-shards over "data" and
    all-reduces T_loc × D over "model" (and the aux loss over DP in
    train); train doubles the forward and reduce-scatters the gathered
    expert gradients.

``collective_bytes`` (the HLO parser) is kept as a verbatim copy of
JAX's, for HLO text from elsewhere. The dry-run runs PyTorch's fake
process-group backend at the mesh's world size, in its own process: the
mesh is real (``init_device_mesh``), the collectives are counted, never
run. Without that backend it raises; it does not fall back to
single-device numbers. Records land in ``experiments/artifacts/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import axis_sizes, make_mesh, make_production_mesh, mesh_devices
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import Model, input_specs
from repro_torch.optim import adamw
from repro_torch.utils.tree import flatten_with_path

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "artifacts", "dryrun_torch")

_COLLECTIVE_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[^\]]*\])\S*\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}


def collective_bytes(hlo_text: str) -> Dict[str, Any]:
    """Sum output bytes of every collective op in optimized HLO text."""
    per_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        shape_part, op = m.group(1), m.group(2)
        if m.group(3) == "-start" and f"{op}-done" in hlo_text:
            pass  # count the -start (has the shape); -done lines don't match
        nbytes = 0
        for dm in _SHAPE_RE.finditer(shape_part):
            dt, dims = dm.group(1), dm.group(2)
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            nbytes += n * _DTYPE_BYTES[dt]
        per_op[op] = per_op.get(op, 0) + nbytes
        counts[op] = counts.get(op, 0) + 1
    return {"bytes_by_op": per_op, "counts": counts,
            "total_bytes": sum(per_op.values())}


def calibration_depths(cfg: ModelConfig) -> Tuple[int, int]:
    """Two unrolled depths whose linear fit extrapolates to full depth.

    Layers are homogeneous within a family's repeat unit (super-block for
    xlstm, attn_every window for zamba2), so per-layer deltas are exact.
    """
    if cfg.family == "hybrid":
        u = cfg.attn_every
        return u, 2 * u
    if cfg.family == "ssm":
        u = cfg.mlstm_per_slstm + 1
        return u, 2 * u
    return 2, 4


def depth_variant(cfg: ModelConfig, depth: int) -> ModelConfig:
    kw = dict(num_layers=depth, scan_layers=False)
    if cfg.family == "encdec":
        kw["encoder_layers"] = depth
    return dataclasses.replace(cfg, **kw)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """PyTorch's fake process-group backend at ``world_size``, rank 0, for
    the block: meshes build, collectives are never run."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry-run needs PyTorch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this installation "
            "lacks; it does not fall back to single-device numbers") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; run the dry-run "
                           "in its own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- the step
def opt_dtype_for(cfg: ModelConfig) -> str:
    """bf16 moments for ≥100B-param models (memory), as JAX's dry-run."""
    return "bfloat16" if cfg.param_count() > 1e11 else "float32"


def build_step(cfg: ModelConfig, shape: ShapeCell, opt_state_dtype: str):
    """(fn, meta argument tuple, kind) for one cell."""
    from repro_torch.launch.train import make_train_step

    model = Model(cfg)
    specs = input_specs(cfg, shape)
    params = model.init_abstract()
    if shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(state_dtype=opt_state_dtype)
        opt = adamw.init_state(opt_cfg, params)
        return make_train_step(cfg, opt_cfg, total_steps=1000, warmup=20), \
            (params, opt, specs["batch"]), "train"
    if shape.kind == "prefill":
        return model.prefill, (params, specs["inputs"], specs["cache"]), "prefill"
    if shape.kind == "decode":
        return model.decode_step, (params, specs["tokens"], specs["cache"]), "decode"
    raise ValueError(shape.kind)


class _ByteCounter(TorchDispatchMode):
    """Bytes every non-view aten op reads and writes, each once."""

    _FREE = (torch.ops.aten.detach.default, torch.ops.aten.lift_fresh.default)

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in self._FREE:
            self.bytes += sum(t.nbytes for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count_cost(fn, args) -> Tuple[Dict[str, float], Any]:
    """({"flops", "bytes accessed"} of one call of ``fn(*args)`` on meta,
    whole step), its outputs."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with kernel_ops.plain_versions(), flops, nbytes:
        out = fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes accessed": float(nbytes.bytes)}, out


# ------------------------------------------------------------------- bytes
def tree_bytes(tree: Any, mesh, spec_of) -> int:
    """Sum over ``tree``'s leaves of one device's block in bytes,
    ``spec_of(path, leaf)`` giving each leaf's spec."""
    total = 0
    for path, leaf in flatten_with_path(tree):
        spec = spec_of(shd.leaf_path_str(path), leaf)
        total += math.prod(shd.local_shape(tuple(leaf.shape), spec, mesh)) * leaf.element_size()
    return total


def step_bytes(cfg: ModelConfig, shape: ShapeCell, mesh, kind: str, args, out) -> Dict[str, int]:
    """{argument_size_in_bytes, output_size_in_bytes} on one device.

    ``args`` are the full-depth step's meta arguments; ``out`` the outputs
    of a run at any depth, read only for what does not depend on it (the
    logits, the train metrics): the outputs' params, AdamW state and cache
    are the arguments' trees, updated."""

    def param(path, leaf):
        return shd.param_spec(path, tuple(leaf.shape), mesh, cfg)

    def data(path, leaf):
        return shd.input_spec(path, tuple(leaf.shape), mesh, cfg, shape)

    def cache(path, leaf):
        return shd.input_spec(path, tuple(leaf.shape), mesh, cfg, shape, is_cache=True)

    def opt(path, leaf):  # "mu/..." and "nu/..." follow the params; "step" is a scalar
        return param(path.split("/", 1)[1], leaf) if "/" in path else ()

    if kind == "train":
        params, opt_state, batch = args
        kept = tree_bytes(params, mesh, param) + tree_bytes(opt_state, mesh, opt)
        return {"argument_size_in_bytes": kept + tree_bytes(batch, mesh, data),
                "output_size_in_bytes": kept + tree_bytes(out[2], mesh, data)}
    params, inputs, cache_tree = args
    kept = tree_bytes(cache_tree, mesh, cache)
    return {"argument_size_in_bytes": (tree_bytes(params, mesh, param)
                                       + tree_bytes(inputs, mesh, data) + kept),
            "output_size_in_bytes": tree_bytes(out[0], mesh, data) + kept}


# ------------------------------------------------------------- collectives
_OUT_PROJ = re.compile(r"(wo|out_proj|down_proj)$")
_EXPERT = re.compile(r"moe/w[io]$")


def _add(census: Dict[str, Dict[str, float]], op: str, nbytes: float, n: int = 1) -> None:
    if nbytes > 0:
        census["bytes_by_op"][op] = census["bytes_by_op"].get(op, 0) + nbytes
        census["counts"][op] = census["counts"].get(op, 0) + n


def _step_tokens(cfg: ModelConfig, shape: ShapeCell, mesh, encoder: bool) -> int:
    """The tokens one device holds in the step: the batch split over the DP
    axes where it divides, else the sequence over "data" (as ``data_spec``)."""
    seq = 1 if shape.kind == "decode" else shape.seq_len
    if encoder:
        seq = cfg.frontend_seq or shape.seq_len
    spec = shd.data_spec((shape.global_batch, seq), mesh, cfg, shape.global_batch)
    return math.prod(shd.local_shape((shape.global_batch, seq), spec, mesh))


def collective_census(cfg: ModelConfig, shape: ShapeCell, mesh, params, kind: str
                      ) -> Dict[str, Any]:
    """The per-device collective bytes of one step, by op (module docstring)."""
    sizes = axis_sizes(mesh)
    data_n, model_n = sizes.get("data", 1), sizes.get("model", 1)
    dp_axes = tuple(a for a in moe_lib.DP_AXES if a in sizes)
    dp_n = math.prod(sizes[a] for a in dp_axes)
    train = kind == "train"
    act = torch.empty((), dtype=cfg.cdtype).element_size()
    census: Dict[str, Any] = {"bytes_by_op": {}, "counts": {}}
    passes = (2 + int(cfg.remat)) if train else 1  # forward, remat recompute, backward

    moe_layer: Dict[str, Any] = {}
    for path, leaf in flatten_with_path(params):
        name = shd.leaf_path_str(path)
        shp = tuple(leaf.shape)
        spec = shd.param_spec(name, shp, mesh, cfg)
        block = math.prod(shd.local_shape(shp, spec, mesh)) * leaf.element_size()
        axes_on = {a for e in spec for a in shd._axes_of(e)}
        if _EXPERT.search(name.lower()):
            moe_layer[name.rsplit("/", 1)[1]] = (leaf, block)
            continue
        if "data" in axes_on:
            gathers = 2 if train else 1  # train: again for the backward
            _add(census, "all-gather", gathers * block * data_n, gathers)
            if train:
                _add(census, "reduce-scatter", block)
        if train:
            rest = math.prod(sizes[a] for a in dp_axes if a not in axes_on)
            if rest > 1:
                _add(census, "all-reduce", block)
        if (_OUT_PROJ.search(name.lower()) and len(shp) >= 2
                and spec[-2] is not None and "model" in shd._axes_of(spec[-2])):
            encoder = name.startswith("enc_")
            if encoder and kind == "decode":
                continue
            uses = (cfg.num_layers // cfg.attn_every if name.startswith("shared/")
                    else math.prod(shp[:-2]))
            out_bytes = _step_tokens(cfg, shape, mesh, encoder) * shp[-1] * act
            _add(census, "all-reduce", uses * passes * out_bytes, uses * passes)

    if moe_layer:
        (wi, wi_block), (wo, wo_block) = moe_layer["wi"], moe_layer["wo"]
        layers = cfg.num_layers
        per_layer = (wi.numel() + wo.numel()) // layers
        t = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        plan = moe_lib.choose_plan(t, per_layer, act, cfg.d_model, model_n, dp_n)
        fwd = 2 if train else 1
        if plan == "token-route":
            _add(census, "all-gather", fwd * layers * t * cfg.d_model * act, fwd * layers)
            _add(census, "all-reduce", fwd * layers * t * cfg.d_model * act, fwd * layers)
        else:
            gathered = (wi_block + wo_block) * data_n
            _add(census, "all-gather", fwd * gathered, fwd * 2 * layers)
            _add(census, "all-reduce", fwd * layers * (t // dp_n) * cfg.d_model * act,
                 fwd * layers)
            if train:
                _add(census, "all-reduce", layers * 4, layers)  # the aux loss over DP
                _add(census, "reduce-scatter", wi_block + wo_block, 2 * layers)
        census["moe_plan"] = plan
    census["total_bytes"] = sum(census["bytes_by_op"].values())
    return census


# ------------------------------------------------------------------ a cell
def calibrate_cell(cfg: ModelConfig, shape: ShapeCell, mesh, opt_state_dtype: str,
                   verbose: bool = True) -> Tuple[Dict[str, Any], Any]:
    """The counts at the two depths of :func:`calibration_depths`, and the
    first run's outputs."""
    d1, d2 = calibration_depths(cfg)
    n_dev = mesh_devices(mesh)
    cal: Dict[str, Any] = {"depths": [d1, d2], "full_depth": cfg.num_layers, "points": []}
    first_out = None
    for d in (d1, d2):
        cfg_d = depth_variant(cfg, d)
        t0 = time.perf_counter()  # reprolint: disable=wallclock
        fn, args, kind = build_step(cfg_d, shape, opt_state_dtype)
        cost, out = count_cost(fn, args)
        coll = collective_census(cfg_d, shape, mesh, args[0], kind)
        seconds = time.perf_counter() - t0  # reprolint: disable=wallclock
        first_out = out if first_out is None else first_out
        cal["points"].append({
            "depth": d, "cost": {k: v / n_dev for k, v in cost.items()},
            "collective_total_bytes": coll["total_bytes"],
            "collective_bytes_by_op": coll["bytes_by_op"],
            "compile_s": round(seconds, 2),
        })
        if verbose:
            print(f"  calib depth={d}: flops={cost['flops'] / n_dev:.3e} "
                  f"coll={coll['total_bytes'] / 1e9:.3f} GB ({seconds:.1f}s)")
    return cal, first_out


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool = False, mesh=None,
                opt_state_dtype: Optional[str] = None, calibrate: bool = True,
                save: bool = True, verbose: bool = True) -> Dict[str, Any]:
    """One record; ``mesh`` (on an initialised process group) defaults to
    the production mesh. With ``calibrate`` the step runs at the two
    calibration depths only and ``cost_analysis`` is their fit at full
    depth; without, it runs once at full depth."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_tag = "pod2" if multi_pod else "pod1"
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if not cfg.supports_shape(shape):
        record["status"] = "skipped"
        record["skip_reason"] = cfg.skip_reason(shape)
        if save:
            _save(record)
        return record

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh_devices(mesh)
    record["mesh_shape"] = {k: int(v) for k, v in axis_sizes(mesh).items()}
    if opt_state_dtype is None:
        opt_state_dtype = opt_dtype_for(cfg)
    record["opt_state_dtype"] = opt_state_dtype

    t0 = time.perf_counter()  # reprolint: disable=wallclock
    fn, args, kind = build_step(cfg, shape, opt_state_dtype)
    if calibrate:
        cal, out = calibrate_cell(cfg, shape, mesh, opt_state_dtype, verbose=verbose)
        record["calibration"] = cal
        cost = {k: _fit(cal, k) for k in ("flops", "bytes accessed")}
    else:
        cost, out = count_cost(fn, args)
        cost = {k: v / n_dev for k, v in cost.items()}
    seconds = time.perf_counter() - t0  # reprolint: disable=wallclock
    record.update(status="ok", kind=kind, devices=n_dev, lower_s=round(seconds, 2),
                  compile_s=0.0, memory_analysis=step_bytes(cfg, shape, mesh, kind, args, out),
                  cost_analysis=cost,
                  collectives=collective_census(cfg, shape, mesh, args[0], kind))
    if verbose:
        print(f"[dryrun] {arch} × {shape_name} × {mesh_tag}: OK (meta runs {seconds:.1f}s "
              "on the host)")
        print(f"  memory_analysis: {record['memory_analysis']}")
        print(f"  cost_analysis: {record['cost_analysis']}")
        print(f"  collectives: {record['collectives']['counts']} "
              f"total {record['collectives']['total_bytes'] / 1e9:.3f} GB")
    if save:
        _save(record)
    return record


def _fit(cal: Dict[str, Any], key: str) -> float:
    """The two calibration points' linear fit at full depth."""
    (d1, p1), (d2, p2) = [(p["depth"], p["cost"][key]) for p in cal["points"]]
    return p1 + (p2 - p1) / (d2 - d1) * (cal["full_depth"] - d1)


def _save(record: Dict[str, Any]) -> None:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(ARTIFACT_DIR, name), "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    from repro_torch.roofline.analysis import analyze_record, format_table

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="all", help="arch id or 'all'")
    p.add_argument("--shape", default="all", help="shape name or 'all'")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--mesh-shape", default=None,
                   help="debug override, e.g. '4,4' (axes data,model)")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--no-calibrate", action="store_true",
                   help="skip the two-depth cost calibration")
    args = p.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES_BY_NAME) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    t_start = time.perf_counter()  # reprolint: disable=wallclock
    failures, rows = [], []
    for mp in meshes:
        if args.mesh_shape:
            dims = tuple(int(x) for x in args.mesh_shape.split(","))
            axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
        else:
            dims = (2, 16, 16) if mp else (16, 16)
            axes = ("pod", "data", "model") if mp else ("data", "model")
        with fake_process_group(math.prod(dims)):
            mesh = make_mesh(dims, axes)
            for arch in archs:
                for shape in shapes:
                    try:
                        # calibration (roofline terms) only on the single-pod
                        # mesh — the multi-pod pass proves the pod axis shards
                        rec = dryrun_cell(arch, shape, multi_pod=mp, mesh=mesh,
                                          save=not args.no_save,
                                          calibrate=(not mp) and not args.no_calibrate)
                        rows.append(analyze_record(rec))
                    except Exception as e:
                        failures.append((arch, shape, mp, repr(e)))
                        print(f"[dryrun] {arch} × {shape} × {'pod2' if mp else 'pod1'}: "
                              f"FAILED — {e}", file=sys.stderr)
    print("\n[roofline] per device, H100 SXM constants (host-only figures):")
    print(format_table(rows))
    host_s = time.perf_counter() - t_start  # reprolint: disable=wallclock
    print(f"[dryrun] host seconds {host_s:.2f}")
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILURES:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        sys.exit(1)
    print("\n[dryrun] all requested cells ran on meta.")


if __name__ == "__main__":
    main()
