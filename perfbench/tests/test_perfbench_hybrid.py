"""The hybrid family's yardstick (``lib/hybrid_counts.py``) against hand
counts, its readers on traced slices, the hybrid reference's fp8 control
against bfloat16, and a whole run of a small hybrid cell on the CPU:
clean, it comes out correct; with its decode state frozen, not."""
import copy
import dataclasses
import importlib.util
import io
import json
import types
from contextlib import redirect_stdout

import pytest
import torch

from perfbench.lib import check, hybrid_counts, roofline, spec, weights

_SPEC = importlib.util.spec_from_file_location("perfbench_run_cli_hybrid",
                                               spec.BENCH_DIR / "run.py")
run = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(run)

#: the published Zamba2 layout at a small size
MODEL = dict(name="small-zamba2", family="hybrid", num_layers=7, d_model=64, num_heads=4,
             num_kv_heads=4, head_dim=32, d_ff=96, vocab_size=128, activation="geglu",
             norm="rmsnorm", norm_eps=1e-5, tie_embeddings=True, rope_theta=1e4,
             max_seq_len=64, ssm_state=16, ssm_head_dim=16, ssm_chunk=8, ssm_groups=2,
             hybrid_layer_ids=[1, 3, 6], num_mem_blocks=2, attention_hidden_size=128,
             adapter_rank=8, param_dtype="float32", compute_dtype="float32")


def test_ssd_counts():
    # x and y 2*10*4*8 = 640 elements each, bf16; dt 80 f32; B and C
    # 2*10*2*16 = 640 each, bf16; a 4 f32. Chunks of 8 and 2 rows: C·Bᵀ
    # (16·2) and w·x (8·4) over 36 and 3 causal pairs a row of the batch,
    # the state read into the second chunk (2 rows) and written out of the
    # first (8 rows), 2·16·8·4 a row
    nbytes, flops = hybrid_counts.ssd_cost(2, 10, 4, 8, 16, 2, 8)
    assert nbytes == 2 * 2 * 640 + 4 * 80 + 2 * 2 * 640 + 16
    assert flops == 2 * 2 * (36 + 3) * 64 + 2 * 2 * (2 + 8) * 16 * 8 * 4


def test_request_flops_count_every_layer_and_application():
    d, f, di = 64, 96, 128
    conv = di + 2 * 2 * 16
    mamba = 2 * d * (di + conv + 8) + 2 * 4 * conv + 4 * 8 * 16 * 16 + 2 * di * d
    block = (2 * 128 * 32 * 12 + 2 * 4 * 32 * d + 2 * d * 2 * f + 2 * f * d
             + 2 * 8 * (d + 2 * f) + 2 * d * d)
    assert hybrid_counts.token_flops(MODEL) == 7 * mamba + 3 * block
    # 5 tokens through the layers (4 prompt + 2 generated but the last), 15
    # (query, key) pairs at 4·4·32 flops at each of 3 applications, the head
    # for 2 generated tokens
    assert hybrid_counts.request_flops(MODEL, 4, 2) == (
        5 * hybrid_counts.token_flops(MODEL) + 15 * 4 * 4 * 32 * 3 + 2 * 2 * d * 128)


def _record(model, ssd_seen=7):
    """A traced slice of one (bucket 2, prompt 4) batch of 3 tokens: 7 SSD
    launches, 3 flash launches and 2 × 3 decode launches."""
    names = {"ssd": "void (anonymous namespace)::ssd_mma_kernel<64, 64>(P)",
             "flash": "void (anonymous namespace)::flash_mma_kernel<32>(P)",
             "decode": "void (anonymous namespace)::decode_split_kernel<4>(P)"}
    events = [(names["ssd"], True, 10.0 * i, 10.0 * i + 4) for i in range(ssd_seen)]
    events += [(names["flash"], True, 100.0 + i, 100.5 + i) for i in range(3)]
    events += [(names["decode"], True, 200.0 + i, 200.25 + i) for i in range(6)]
    profile = types.SimpleNamespace(events=events, window_s=1e-3,
                                    batches=[types.SimpleNamespace(bucket=2, plen=4)])
    return types.SimpleNamespace(model=model, mix={"gen_len": 3}, profile=profile)


@pytest.mark.parametrize("ssd_seen, read", [(7, True), (6, False)])
def test_roofline_shares_need_every_launch(ssd_seen, read):
    rec = _record(MODEL, ssd_seen)
    share = hybrid_counts.roofline_share(rec, "ssd_scan")
    bound = roofline.bound_s(*hybrid_counts.ssd_cost(2, 4, 8, 16, 16, 2, 8))
    assert share == (pytest.approx(100.0 * 7 * bound / 28e-6) if read else None)
    flash = roofline.bound_s(*roofline.flash_cost(2, 4, 4, 4, 32))
    assert hybrid_counts.roofline_share(rec, "flash_attention") == pytest.approx(
        100.0 * 3 * flash / 1.5e-6)
    decode = sum(roofline.bound_s(*roofline.decode_cost(2, n, 4, 4, 32)) for n in (5, 6))
    assert hybrid_counts.roofline_share(rec, "decode_attention") == pytest.approx(
        100.0 * 3 * decode / 1.5e-6)
    with pytest.raises(AssertionError):
        hybrid_counts.roofline_share(_record(MODEL, 8), "ssd_scan")


def test_the_hybrid_readers_read_nothing_of_another_family():
    dense = {"family": "dense", "num_layers": 1}
    rec = _record(dense)
    rec.window, rec.batches = (0.0, 1.0), []
    for name in ("ssd_scan_roofline", "hybrid_flash_roofline", "hybrid_decode_attn_roofline",
                 "hybrid_step_mfu"):
        assert spec.metric_reader(name).read(rec) is None


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: (v if k in ("a_log", "dt_bias", "d_skip") else _bf16(v))
                for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def test_fp8_control_reads_far_above_bfloat16():
    """At each position of the same sequences, the gap below the float32
    reference's best of the token that bf16 (the port's forward) ranks
    first, and of the token fp8 (the control) ranks first: the control's
    smallest over three seeds is over three times bf16's largest."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    model = dict(MODEL, d_model=128, d_ff=192, attention_hidden_size=256, head_dim=64,
                 vocab_size=512)
    ref = spec.reference("hybrid")
    bf16 = Model(ModelConfig(**dict(model, param_dtype="bfloat16", compute_dtype="bfloat16")))
    f32 = Model(ModelConfig(**model))
    low, high = [], []
    for seed in (1, 2, 3):
        params = weights.make(f32.init_abstract(), seed, "cpu", extra=ref.WEIGHTS)
        tokens = torch.randint(0, 512, (4, 24), generator=torch.Generator().manual_seed(seed))
        want = ref.logits(model, params, tokens, 8)
        best = want.max(-1).values
        for picks, out in ((bf16.forward(_bf16(params), tokens)[:, 8:], low),
                           (ref.logits(model, params, tokens, 8, mm=check.fp8_mm), high)):
            chosen = want.gather(-1, picks.argmax(-1, keepdim=True))[..., 0]
            out.append(float((best - chosen).max()))
    assert min(high) > 3 * max(low), (low, high)


MIX = {"config": "small-zamba2", "prompt_len": 12, "gen_len": 4, "replicas": 1,
       "engine": {"batch_buckets": [1, 2, 4]}, "policy": "mlproxy",
       "policy_settings": {"bucketing": "pow2",
                           "optimizer": {"update_interval": 5.0, "initial_max_bs": 2}},
       "arrivals": {"process": "mmpp2", "rate": 30.0, "low_share": 0.7, "high_share": 1.6,
                    "mean_dwell_low_s": 6.0, "mean_dwell_high_s": 3.0},
       "slo_ms": 500.0, "lead_in_s": 0.3, "drain_limit_s": 10.0, "profile_slice_s": 0.3,
       "profile_max_batches": 4,
       "check": {"sample": 6, "rows_per_block": 3, "logit_gap_limit": 0.1}}
CELL = spec.Cell(name="zamba2-7b-chat-burst", config_name="small-zamba2", traffic="small",
                 chips=1, config={"model": MODEL}, mix=MIX)


def _run(monkeypatch):
    monkeypatch.setattr(run.bench, "forbidden_modules", lambda: [])
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELL.name, "--seed", str(2 ** 33 + 5), "--seconds", "0.8",
                       "--trace", "0"], device="cpu", cell=copy.deepcopy(CELL))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_clean_hybrid_run_is_correct(monkeypatch):
    line = _run(monkeypatch)
    assert line["correct"] is True
    assert line["attempted"] > 10 and line["failed"] == 0
    assert line["checks"]["logit_gap"]["value"] <= 1e-3


def test_a_frozen_decode_state_is_not_correct(monkeypatch):
    from repro_torch.models import hybrid

    step = hybrid.decode_step

    def frozen(cfg, params, tokens, cache, rope=None):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, _ = step(cfg, params, tokens, cache, rope=rope)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache

    monkeypatch.setattr(hybrid, "decode_step", frozen)
    line = _run(monkeypatch)
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > MIX["check"]["logit_gap_limit"]


def test_the_config_as_run_is_the_published_one():
    """Every published width of zamba2-7b's file is the port's, as run."""
    from repro_torch.configs import get_config

    data = spec.config_file(spec.benchmark(), "zamba2-7b")
    cfg = get_config("zamba2-7b")
    pairs = {"num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
             "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
             "attention_head_dim": cfg.hd, "attention_hidden_size": cfg.attention_hidden_size,
             "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
             "mamba_d_state": cfg.ssm_state, "mamba_headdim": cfg.ssm_head_dim,
             "mamba_ngroups": cfg.ssm_groups, "num_mem_blocks": cfg.num_mem_blocks,
             "adapter_rank": cfg.adapter_rank, "rms_norm_eps": cfg.norm_eps,
             "rope_theta": cfg.rope_theta, "max_position_embeddings": cfg.max_seq_len,
             "hybrid_layer_ids": list(cfg.hybrid_layer_ids),
             "n_mamba_heads": 2 * cfg.d_model // cfg.ssm_head_dim}
    assert {k: data[k] for k in pairs} == pairs
    assert data["layers_block_type"] == ["hybrid" if i in cfg.hybrid_layer_ids else "mamba"
                                         for i in range(cfg.num_layers)]
    assert data["reduced"] == [] and dataclasses.asdict(cfg)["tie_embeddings"] is True
