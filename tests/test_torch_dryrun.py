"""The port's meta-device dry-run and roofline, on the CPU.

* Reduced qwen2-0.5b's prefill FLOPs (``FlopCounterMode`` on meta) equal
  the closed form of what the port computes.
* The two-depth fit equals a direct count at full depth, for a dense and
  a hybrid config (FLOPs and bytes, exactly).
* The collective census picks JAX's MoE plan (kimi-k2: token-route at
  decode_32k, weight-gather at prefill_32k on (16, 16)).
* A record written by ``dryrun_cell`` and read back by
  ``roofline_table``; the CLI end to end on a (2, 2) fake mesh; no fake
  backend raises.
* The ``collective_bytes`` copy passes JAX's parser case, and the roofline
  math mirrors ``tests/test_distribution.py`` with the H100 constants.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch.dryrun import collective_bytes as jax_collective_bytes
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as dr
from repro_torch.models.model import Model
from repro_torch.roofline import analysis as rl

ROOT = Path(__file__).resolve().parents[1]


class TMesh:
    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)


POD1 = TMesh((16, 16), ("data", "model"))


def test_reduced_prefill_flops_equal_the_closed_form():
    cfg = get_config("qwen2-0.5b").reduced()
    b, s = 4, 64
    fn, args, _ = dr.build_step(cfg, ShapeCell("p", s, b, "prefill"), "float32")
    cost, (logits, _) = dr.count_cost(fn, args)
    d, h, kv, hd, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                          cfg.d_ff, cfg.vocab_size)
    # q/k/v and out projections, the gated MLP's fused [gate|up] and down
    per_token = 2 * d * (h + 2 * kv) * hd + 2 * h * hd * d + 2 * d * 2 * f + 2 * f * d
    # the plain attention's full score matrix and its product with v
    attention = 4 * b * h * s * s * hd
    unembed = 2 * b * d * v  # last position only
    assert cost["flops"] == cfg.num_layers * (b * s * per_token + attention) + unembed
    assert tuple(logits.shape) == (b, 1, v) and logits.is_meta


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch,layers", [("qwen2-0.5b", 6), ("zamba2-1.2b", 8)])
def test_two_depth_fit_equals_a_direct_count(arch, layers, kind):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    cell = ShapeCell("x", 32, 2, kind)
    direct, _ = dr.count_cost(*dr.build_step(cfg, cell, "float32")[:2])
    points = [{"depth": d, "cost": dr.count_cost(*dr.build_step(
        dr.depth_variant(cfg, d), cell, "float32")[:2])[0]}
        for d in dr.calibration_depths(cfg)]
    cal = {"points": points, "full_depth": layers}
    for key in ("flops", "bytes accessed"):
        assert dr._fit(cal, key) == direct[key]
        assert rl._extrapolate(points, layers, lambda p: p["cost"][key]) == direct[key]


@pytest.mark.parametrize("shape,plan", [("decode_32k", "token-route"),
                                        ("prefill_32k", "weight-gather")])
def test_census_picks_jax_moe_plan(shape, plan):
    from repro_torch.configs import SHAPES_BY_NAME

    cfg = get_config("kimi-k2-1t-a32b")
    cell = SHAPES_BY_NAME[shape]
    census = dr.collective_census(cfg, cell, POD1, Model(cfg).init_abstract(), cell.kind)
    assert census["moe_plan"] == plan
    assert census["total_bytes"] == sum(census["bytes_by_op"].values()) > 0


def test_record_round_trip_and_roofline(tmp_path, monkeypatch):
    monkeypatch.setattr(dr, "ARTIFACT_DIR", str(tmp_path))
    rec = dr.dryrun_cell("qwen2-0.5b", "decode_32k", mesh=TMesh((2, 2), ("data", "model")),
                         verbose=False)
    skipped = dr.dryrun_cell("qwen2-0.5b", "long_500k", verbose=False)
    assert skipped["status"] == "skipped" and skipped["skip_reason"] == "full-attention@500k"
    assert rec["status"] == "ok" and rec["devices"] == 4 and rec["kind"] == "decode"
    assert rec["mesh_shape"] == {"data": 2, "model": 2}
    assert rec["opt_state_dtype"] == "float32"
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    rows = {r.shape: r for r in rl.roofline_table("pod1", str(tmp_path))}
    assert rows["long_500k"].status == "skipped"
    row = rows["decode_32k"]
    assert row.flops == pytest.approx(rec["cost_analysis"]["flops"])
    assert row.t_memory == pytest.approx(row.bytes_hbm / 3.35e12)
    assert row.bottleneck in ("compute", "memory", "collective")
    assert "qwen2-0.5b" in rl.format_table(list(rows.values()))


def test_cli_on_a_fake_mesh():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
         "--shape", "decode_32k", "--mesh-shape", "2,2", "--no-save", "--no-calibrate"],
        env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "qwen2-0.5b               decode_32k   ok" in out.stdout
    assert "[dryrun] host seconds" in out.stdout


def test_no_fake_backend_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process-group backend"):
        with dr.fake_process_group(4):
            pass


def test_collective_bytes_parser_matches_jax():
    hlo = """
  %ag = bf16[128,256]{1,0} all-gather(%x), replica_groups={}
  %ar.1 = f32[64]{0} all-reduce(%y), to_apply=%add
  %cp = (s32[8]{0}, s32[8]{0}) collective-permute(%a, %b), channel_id=3
  %nothing = f32[10]{0} add(%p, %q)
"""
    out = dr.collective_bytes(hlo)
    assert out == jax_collective_bytes(hlo)
    assert out["counts"] == {"all-gather": 1, "all-reduce": 1, "collective-permute": 1}
    assert out["bytes_by_op"]["all-gather"] == 128 * 256 * 2
    assert out["bytes_by_op"]["all-reduce"] == 64 * 4
    assert out["bytes_by_op"]["collective-permute"] == 2 * 8 * 4


def test_roofline_math_with_h100_constants():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.COLLECTIVE_BW) == (989e12, 3.35e12, 50e9)
    pts = [{"depth": 2, "v": 10.0}, {"depth": 4, "v": 16.0}]
    assert rl._extrapolate(pts, 10, lambda p: p["v"]) == pytest.approx(34.0)
    row = rl.RooflineRow(arch="a", shape="s", mesh="m", status="ok",
                         t_compute=1.0, t_memory=2.0, t_collective=0.5)
    assert row.dominant() == "memory"
    rec = {"arch": "qwen2-0.5b", "shape": "decode_32k", "mesh": "pod1", "status": "ok",
           "kind": "decode", "devices": 256,
           "cost_analysis": {"flops": 989e9, "bytes accessed": 6.7e9},
           "collectives": {"total_bytes": 1e8}}
    row = rl.analyze_record(rec)
    assert row.t_compute == pytest.approx(1e-3)
    assert row.t_memory == pytest.approx(2e-3)
    assert row.t_collective == pytest.approx(2e-3)
    assert row.bottleneck in ("memory", "collective")
    cfg = get_config("qwen2-0.5b")
    assert row.model_flops == pytest.approx(2 * cfg.active_param_count() * 128 / 256)
