"""The port's training side against the JAX package's: AdamW and its
schedule, train steps, the data pipeline, checkpoints that either package
restores, ``launch/train.py`` and gradient compression.

All on the CPU in f32 (bf16 where a case says so), from the same numpy
inputs; model params carried across with ``convert.from_jax``.
Tolerances: AdamW on random trees and three train steps of reduced qwen2
(losses, ``grad_norm``, params, both moments) to 1e-5; the schedule and
compression to 1e-6; data batches, checkpoints and a restarted run
bit for bit.
"""
import dataclasses
import os
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenDataset as JTokenDataset
from repro.distributed import checkpoint as jckpt
from repro.distributed import compression as jcomp
from repro.launch.train import make_train_step as jmake_train_step
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.data.pipeline import DataConfig, TokenDataset
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression as comp
from repro_torch.kernels import ops
from repro_torch.launch.train import TrainConfig, batch_to, make_train_step, train
from repro_torch.optim import adamw
from repro_torch.utils.tree import flatten_with_path, leaves

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro\.", re.M)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32) if np.asarray(x).dtype.name == "bfloat16"
                      else x)


def _close_trees(got, want, tol, what=""):
    """A port tree (tensors) against a JAX tree, leaf for leaf in order."""
    jflat = jax.tree_util.tree_leaves(want)
    tflat = leaves(got)
    assert len(jflat) == len(tflat), what
    for g, w in zip(tflat, jflat):
        np.testing.assert_allclose(_np(g), _np(np.asarray(w)), atol=tol, rtol=tol, err_msg=what)


# ------------------------------------------------------------------ AdamW
def _trees(seed, param_dtype, grad_scale):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((5, 3)), "blk": {"z": rng.standard_normal(7),
                                                   "a": rng.standard_normal((2, 2, 2))},
         "count": np.arange(4, dtype=np.int32)}
    g = {"w": rng.standard_normal((5, 3)) * grad_scale,
         "blk": {"z": rng.standard_normal(7) * grad_scale,
                 "a": rng.standard_normal((2, 2, 2)) * grad_scale},
         "count": np.zeros(4, np.int32)}

    def cast(t):
        return {k: cast(v) if isinstance(v, dict) else
                (v if v.dtype == np.int32 else v.astype(np.float32)) for k, v in t.items()}

    p, g = cast(p), cast(g)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt) if a.dtype != np.int32 else jnp.asarray(a), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a, jdt) if a.dtype != np.int32 else jnp.asarray(a), g)
    tp = convert.from_jax(jax.device_get(jp))
    tg = convert.from_jax(jax.device_get(jg))
    return jp, jg, tp, tg


@pytest.mark.parametrize("param_dtype,state_dtype,grad_scale", [
    ("float32", "float32", 1.0),     # clipping active (norm ~5 > 1)
    ("float32", "float32", 0.01),    # clipping inactive
    ("float32", "bfloat16", 1.0),    # bf16 moments
    ("bfloat16", "float32", 1.0),    # bf16 params and grads, as the full configs train
])
def test_apply_updates_matches_jax(param_dtype, state_dtype, grad_scale):
    jcfg = jadamw.AdamWConfig(learning_rate=1e-2, state_dtype=state_dtype)
    tcfg = adamw.AdamWConfig(learning_rate=1e-2, state_dtype=state_dtype)
    jp, jg, tp, tg = _trees(0, param_dtype, grad_scale)
    jst, tst = jadamw.init_state(jcfg, jp), adamw.init_state(tcfg, tp)
    for step in range(3):
        lr_j = jadamw.cosine_schedule(jst.step, warmup=1, total=10)
        lr_t = adamw.cosine_schedule(tst.step, warmup=1, total=10)
        jp, jst, jm = jadamw.apply_updates(jcfg, jp, jg, jst, lr_scale=lr_j)
        with torch.no_grad():
            tp, tst, tm = adamw.apply_updates(tcfg, tp, tg, tst, lr_scale=lr_t)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= TOL * float(jm["grad_norm"])
        assert int(tst.step) == int(jst.step) == step + 1
        _close_trees(tp, jp, TOL, "params")
        _close_trees(tst.mu, jst.mu, TOL, "mu")
        _close_trees(tst.nu, jst.nu, TOL, "nu")
    assert tp["count"].dtype == torch.int32 and torch.equal(tp["count"], torch.arange(4,
                                                                                   dtype=torch.int32))
    assert tst.mu["w"].dtype == getattr(torch, state_dtype)
    assert tp["w"].dtype == getattr(torch, param_dtype)
    if grad_scale == 1.0:
        assert float(tm["grad_norm"]) > 1.0  # the clip was active


def test_cosine_schedule_matches_jax():
    for step in (0, 1, 5, 10, 37, 100, 150):
        want = float(jadamw.cosine_schedule(jnp.asarray(step), warmup=10, total=100))
        got = float(adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                          warmup=10, total=100))
        assert abs(got - want) <= 1e-6, step


# the four AdamW checks of tests/test_substrate.py, on the port
def test_adamw_reduces_quadratic():
    cfg = adamw.AdamWConfig(learning_rate=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init_state(cfg, params)
    for _ in range(100):
        with torch.no_grad():
            params, state, _ = adamw.apply_updates(cfg, params, {"w": 2 * params["w"]}, state)
    assert float(torch.sum(params["w"] ** 2)) < 1e-2


def test_adamw_grad_clip():
    cfg = adamw.AdamWConfig(grad_clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = adamw.init_state(cfg, params)
    _, _, metrics = adamw.apply_updates(cfg, params, {"w": torch.tensor([100.0, 0.0, 0.0])},
                                        state)
    assert float(metrics["grad_norm"]) == pytest.approx(100.0)


def test_adamw_bf16_state_dtype():
    cfg = adamw.AdamWConfig(state_dtype="bfloat16")
    state = adamw.init_state(cfg, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert state.mu["w"].dtype == torch.bfloat16


def test_cosine_schedule_shape():
    assert float(adamw.cosine_schedule(torch.tensor(0), warmup=10, total=100)) == 0.0
    assert float(adamw.cosine_schedule(torch.tensor(10), warmup=10, total=100)) == \
        pytest.approx(1.0)
    assert float(adamw.cosine_schedule(torch.tensor(100), warmup=10, total=100)) == \
        pytest.approx(0.1)


def test_convert_carries_adamw_state_both_ways():
    jp, _, _, _ = _trees(1, "float32", 1.0)
    jst = jadamw.init_state(jadamw.AdamWConfig(), jp)
    jst = jst._replace(step=jnp.asarray(7, jnp.int32),
                       mu=jax.tree.map(lambda a: a + 1, jst.mu))
    tst = convert.from_jax(jax.device_get(jst))
    assert isinstance(tst, adamw.AdamWState) and tst.step.dtype == torch.int32
    assert int(tst.step) == 7
    _close_trees(tst.mu, jst.mu, 0)
    back = jadamw.AdamWState(*convert.to_numpy(tst))
    assert back.step.dtype == np.int32 and int(back.step) == 7
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- train steps
def test_three_train_steps_match_jax():
    jcfg = jget_config("qwen2-0.5b").reduced()
    tcfg = tget_config("qwen2-0.5b").reduced()
    params_np = jax.device_get(jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0)))
    jopt, topt = jadamw.AdamWConfig(), adamw.AdamWConfig()
    jstep = jax.jit(jmake_train_step(jcfg, jopt, total_steps=10, warmup=1))
    tstep = make_train_step(tcfg, topt, total_steps=10, warmup=1)
    jp = jax.tree.map(jnp.asarray, params_np)
    tp = convert.from_jax(params_np)
    jst, tst = jadamw.init_state(jopt, jp), adamw.init_state(topt, tp)
    data = TokenDataset(DataConfig(seq_len=16, global_batch=2, vocab_size=tcfg.vocab_size))
    for i in range(3):
        batch = next(data)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, tst, tm = tstep(tp, tst, batch_to(batch, "cpu"))
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= TOL * abs(float(jm[key])), (i, key)
        _close_trees(tp, jp, TOL, f"params after step {i + 1}")
        _close_trees(tst.mu, jst.mu, TOL, "mu")
        _close_trees(tst.nu, jst.nu, TOL, "nu")
    assert int(tst.step) == 3
    assert not any(p.requires_grad for p in leaves(tp))


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("rel", ["data/pipeline.py", "data/tokenizer.py"])
def test_data_module_is_a_verbatim_copy(rel):
    want = _IMPORT.sub(r"\1repro_torch.", (ROOT / "src" / "repro" / rel).read_text())
    got = (ROOT / "src" / "repro_torch" / rel).read_text()
    assert got == want, f"src/repro_torch/{rel} differs from its JAX original beyond imports"


def test_batches_and_restore_equal_jax():
    kw = dict(seq_len=32, global_batch=4, vocab_size=100, seed=7)
    jds, tds = JTokenDataset(JDataConfig(**kw)), TokenDataset(DataConfig(**kw))
    for _ in range(3):
        jb, tb = next(jds), next(tds)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[key], jb[key])
    assert tds.state() == jds.state()
    tds2 = TokenDataset(DataConfig(**kw))
    tds2.restore(jds.state())
    np.testing.assert_array_equal(next(tds2)["tokens"], next(jds)["tokens"])
    with pytest.raises(ValueError):
        TokenDataset(DataConfig(**{**kw, "seed": 8})).restore(jds.state())


# --------------------------------------------------------------- checkpoints
def _ckpt_trees():
    """The same {"params", "opt"} tree in both packages, with a bf16 leaf
    and keys whose insertion order is not sorted."""
    rng = np.random.default_rng(5)
    p_np = {"zeta": rng.standard_normal((3, 2)).astype(np.float32),
            "alpha": {"w": rng.standard_normal(4).astype(np.float32),
                      "b16": rng.standard_normal(6).astype(np.float32)}}
    jparams = jax.tree.map(jnp.asarray, p_np)
    jparams["alpha"]["b16"] = jparams["alpha"]["b16"].astype(jnp.bfloat16)
    jopt = jadamw.init_state(jadamw.AdamWConfig(), jparams)
    jopt = jopt._replace(step=jnp.asarray(3, jnp.int32),
                         mu=jax.tree.map(lambda a: a + 0.5, jopt.mu),
                         nu=jax.tree.map(lambda a: a + 0.25, jopt.nu))
    jtree = {"params": jparams, "opt": jopt}
    ttree = {"params": convert.from_jax(jax.device_get(jparams)),
             "opt": convert.from_jax(jax.device_get(jopt))}
    return jtree, ttree


def _manifest(d, step):
    import json

    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def test_checkpoints_cross_between_the_packages(tmp_path):
    jtree, ttree = _ckpt_trees()
    assert ttree["params"]["alpha"]["b16"].dtype == torch.bfloat16
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_checkpoint(dj, 3, jtree, metadata={"data": {"step": 3, "seed": 0}})
    ckpt.save_checkpoint(dt, 3, ttree, metadata={"data": {"step": 3, "seed": 0}})
    mj, mt = _manifest(dj, 3), _manifest(dt, 3)
    assert mt["leaves"] == mj["leaves"] and mt["dtypes"] == mj["dtypes"]
    assert "opt__mu__alpha__b16" in mt["leaves"] and "bfloat16" in mt["dtypes"]
    for name in mj["leaves"]:  # the same files, bit for bit
        a, b = np.load(os.path.join(dj, "step_3", name + ".npy")), \
            np.load(os.path.join(dt, "step_3", name + ".npy"))
        assert a.dtype == b.dtype and np.array_equal(a, b), name

    # JAX's checkpoint into the port, the port's into JAX
    _, tlike = _ckpt_trees()  # a fresh template
    restored, meta = ckpt.restore_checkpoint(dj, 3, tlike)
    assert meta == {"data": {"step": 3, "seed": 0}}
    assert restored["params"]["alpha"]["b16"].dtype == torch.bfloat16
    assert isinstance(restored["opt"], adamw.AdamWState) and int(restored["opt"].step) == 3
    names = ["__".join(p) for p, _ in flatten_with_path(restored)]
    assert names == mj["leaves"]
    for a, b in zip(leaves(restored), leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jrestored, _ = jckpt.restore_checkpoint(dt, 3, jtree)
    assert jrestored["params"]["alpha"]["b16"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(jrestored), jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 10, tree, metadata={"note": "x"})
    assert ckpt.latest_step(d) == 10
    restored, meta = ckpt.restore_checkpoint(d, 10, tree)
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert meta["note"] == "x"


def test_checkpoint_prune_and_latest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, s, {"w": torch.zeros(2)})
    ckpt.prune_checkpoints(d, keep=2)
    assert ckpt.latest_step(d) == 4
    assert sorted(int(x.split("_")[1]) for x in os.listdir(d)) == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 1, {"w": torch.zeros(2)})
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, 1, {"w": torch.zeros(3)})


def test_checkpoint_atomic_commit(tmp_path):
    d = tmp_path / "ckpt"
    (d / "step_5").mkdir(parents=True)  # no manifest.json: not committed
    assert ckpt.latest_step(str(d)) is None
    assert ckpt.restore_latest(str(d), {"w": torch.zeros(2)}) is None


# ------------------------------------------------------------------ train()
def _reduced():
    return tget_config("qwen2-0.5b").reduced()


def test_train_loop_loss_decreases():
    cfg = _reduced()
    ops.reset_launches()
    out = train(cfg, TrainConfig(steps=30, log_every=5, checkpoint_every=100),
                DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size),
                device="cpu")
    assert out["final_loss"] < out["first_loss"]
    assert all(n == 0 for n in ops.launches().values())


def test_restart_from_a_checkpoint_is_bit_identical(tmp_path):
    cfg = _reduced()
    data = DataConfig(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size)
    d = str(tmp_path / "ck")
    tcfg = TrainConfig(steps=20, log_every=10, checkpoint_every=10, checkpoint_dir=d)
    whole = train(cfg, tcfg, data, device="cpu")
    assert ckpt.latest_step(d) == 20
    shutil.rmtree(os.path.join(d, "step_20"))  # as if the run died after step 10
    resumed = train(cfg, tcfg, data, device="cpu")
    assert ckpt.latest_step(d) == 20
    for a, b in zip(leaves({"p": resumed["params"], "o": resumed["opt"]}),
                    leaves({"p": whole["params"], "o": whole["opt"]})):
        assert torch.equal(a, b)
    assert resumed["final_loss"] == whole["final_loss"]


def test_train_on_the_card_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(_reduced(), TrainConfig(steps=1))


# -------------------------------------------------------------- compression
def _grad_trees(seed):
    rng = np.random.default_rng(seed)
    g = {"w": rng.standard_normal((8, 5)).astype(np.float32),
         "b": {"v": rng.standard_normal(13).astype(np.float32)}}
    return jax.tree.map(jnp.asarray, g), convert.from_jax(g)


def test_int8_matches_jax():
    jg, tg = _grad_trees(0)
    jg["n"], tg["n"] = jnp.arange(3, dtype=jnp.int32), torch.arange(3, dtype=torch.int32)
    jc, tc = jcomp.int8_compress(jg), comp.int8_compress(tg)
    assert tc["w"][0].dtype == torch.int8 and tc["n"][1] is None
    np.testing.assert_array_equal(tc["w"][0].numpy(), np.asarray(jc["w"][0]))
    assert abs(float(tc["w"][1]) - float(jc["w"][1])) <= 1e-6 * float(jc["w"][1])
    _close_trees(comp.int8_decompress(tc, tg), jcomp.int8_decompress(jc, jg), 1e-6)


def test_topk_with_error_feedback_matches_jax():
    jcomp_, tcomp_ = jcomp.TopKCompressor(0.2), comp.TopKCompressor(0.2)
    jg, tg = _grad_trees(1)
    jst, tst = jcomp_.init(jg), tcomp_.init(tg)
    for step in range(2):
        if step:
            jg, tg = _grad_trees(2)
        jpay, jst = jcomp_.compress(jg, jst)
        tpay, tst = tcomp_.compress(tg, tst)
        for key in ("w",):
            np.testing.assert_array_equal(tpay[key][1].numpy(), np.asarray(jpay[key][1]))
            np.testing.assert_allclose(tpay[key][0].numpy(), np.asarray(jpay[key][0]), atol=1e-6)
        _close_trees(tst.residual, jst.residual, 1e-6, "residual")
        _close_trees(tcomp_.decompress(tpay, tg), jcomp_.decompress(jpay, jg), 1e-6)
    assert tcomp_.compressed_bytes(tg) == jcomp_.compressed_bytes(jg)
