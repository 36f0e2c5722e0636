"""A whole run on the CPU at a small size, past the look for a card: clean,
it comes out correct; with the timed path broken underneath in each way a
served cell can be broken, it comes out not correct."""
import copy
import importlib.util
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

from perfbench.lib import spec

_SPEC = importlib.util.spec_from_file_location("perfbench_run_cli", spec.BENCH_DIR / "run.py")
run = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(run)

MODEL = dict(name="small-dense", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128, activation="gelu",
             norm="layernorm", qkv_bias=True, mlp_bias=True, rope_theta=1e5, max_seq_len=64,
             param_dtype="float32", compute_dtype="float32")
MIX = {"config": "small-dense", "prompt_len": 8, "gen_len": 4, "replicas": 1,
       "engine": {"batch_buckets": [1, 2, 4]}, "policy": "mlproxy",
       "policy_settings": {"bucketing": "pow2",
                           "optimizer": {"update_interval": 5.0, "initial_max_bs": 2}},
       "arrivals": {"process": "poisson", "rate": 30.0},
       "slo_ms": 500.0, "lead_in_s": 0.3, "drain_limit_s": 10.0, "profile_slice_s": 0.3,
       "profile_max_batches": 4,
       "check": {"sample": 6, "rows_per_block": 3, "logit_gap_limit": 0.1}}
CELL = spec.Cell(name="starcoder2-instruct", config_name="small-dense", traffic="small",
                 chips=1, config={"model": MODEL}, mix=MIX)


@pytest.fixture(autouse=True)
def _jax_loaded_elsewhere(monkeypatch):
    """The test process also holds the JAX package, imported by other test
    files; the run's own check for it is tested in a process of its own
    (``test_perfbench_imports.py``)."""
    monkeypatch.setattr(run.bench, "forbidden_modules", lambda: [])


def _run(trace=0):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", CELL.name, "--seed", str(2 ** 31 + 11), "--seconds", "0.8",
                       "--trace", str(trace)], device="cpu", cell=copy.deepcopy(CELL))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_a_clean_run_is_correct():
    line = _run()
    assert line["correct"] is True
    assert line["attempted"] > 10 and line["failed"] == 0
    assert set(line["metrics"]) == {"p95_ms", "p50_ms", "cost_ms_per_req", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["checks"]["logit_gap"]["value"] <= 1e-3


def _state_unchanged(monkeypatch):
    from repro_torch.models import transformer

    step = transformer.decode_step

    def frozen(cfg, params, tokens, cache, rope=None):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, _ = step(cfg, params, tokens, cache, rope=rope)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache

    monkeypatch.setattr(transformer, "decode_step", frozen)


def _generate_patch(monkeypatch, change):
    from repro_torch.serving import engine

    generate = engine.InferenceEngine.generate

    def broken(self, prompts, gen_len=None):
        return change(self, generate, prompts, gen_len)

    monkeypatch.setattr(engine.InferenceEngine, "generate", broken)


def _half_left_out(monkeypatch):
    def change(self, generate, prompts, gen_len):
        keep = max(1, prompts.shape[0] // 2)
        out, timing = generate(self, prompts[:keep], gen_len)
        rows = np.concatenate([out, out[np.arange(prompts.shape[0] - keep) % keep]])
        return rows, timing
    _generate_patch(monkeypatch, change)


def _token_altered(monkeypatch):
    def change(self, generate, prompts, gen_len):
        out, timing = generate(self, prompts, gen_len)
        out = out.copy()
        out[:, -1] = (out[:, -1] + 1) % self.cfg.vocab_size
        return out, timing
    _generate_patch(monkeypatch, change)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out, _token_altered],
                         ids=["state_unchanged", "half_batch_left_out", "token_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    line = _run()
    assert line["correct"] is False
    assert line["checks"]["logit_gap"]["value"] > MIX["check"]["logit_gap_limit"]
