"""The port's training loss and its gradients against the JAX package's.

Every family on its reduced config in f32, from the same JAX params
(``jax.random`` init, carried across with ``convert.from_jax``) and the
same numpy batch (B = 2, S = 16; seamless-m4t with its 8 stub frames,
internvl2 from float embeddings, llama4-scout at the reduced capacity
factor 8.0, so no token drops): ``Model.loss`` against
``jax.jit(jax.value_and_grad(model.loss))``.

Tolerances:
* ``softmax_cross_entropy``: 1e-6 absolute.
* loss: 1e-5 relative.
* each gradient leaf: max |g_port - g_jax| <= 1e-4 * max |g_jax| of that
  leaf (a leaf JAX gives all zeros must be all zeros).
* remat: the port's gradients with ``remat=True`` equal its own with
  ``remat=False`` to 1e-6 of each leaf's max |g|, and JAX's with
  ``remat=True`` to the tolerance above.

The port trains through the kernels' plain versions (``Model.loss``
enters ``ops.plain_versions()``), as JAX trains through its plain jnp
path; these tests also hold that switch to its own thread.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro.models.model import make_inputs as jmake_inputs
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import SHAPES, ShapeCell
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model, make_inputs
from repro_torch.utils.tree import flatten_with_path, leaves, tree_map

CE_TOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's max |g|
REMAT_TOL = 1e-6

FAMILIES = {
    "dense": "qwen2-0.5b",
    "moe": "llama4-scout-17b-a16e",
    "vlm": "internvl2-76b",
    "hybrid": "zamba2-1.2b",
    "ssm": "xlstm-1.3b",
    "encdec": "seamless-m4t-large-v2",
}
B, S = 2, 16

_PARAMS = {}


def _configs(arch, remat=False):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat=remat)
    tcfg = dataclasses.replace(tget_config(arch).reduced(), remat=remat)
    return jcfg, tcfg


def _params_np(arch):
    if arch not in _PARAMS:
        jcfg, _ = _configs(arch)
        _PARAMS[arch] = jax.device_get(jax.jit(JModel(jcfg).init)(jax.random.PRNGKey(0)))
    return _PARAMS[arch]


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "encdec":
        frames = rng.standard_normal((B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return {"frames": frames, "tokens": tokens, "labels": labels}
    if cfg.embed_inputs:
        inputs = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        return {"inputs": inputs, "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": labels}


def _jax_loss_and_grads(arch, remat=False):
    jcfg, _ = _configs(arch, remat)
    fn = jax.jit(jax.value_and_grad(JModel(jcfg).loss))
    loss, grads = fn(jax.tree.map(jnp.asarray, _params_np(arch)),
                     {k: jnp.asarray(v) for k, v in _batch(jcfg).items()})
    return float(loss), jax.tree_util.tree_flatten_with_path(jax.device_get(grads))[0]


def _port_loss_and_grads(arch, remat=False):
    _, tcfg = _configs(arch, remat)
    params = tree_map(lambda p: p.requires_grad_(True), convert.from_jax(_params_np(arch)))
    loss = Model(tcfg).loss(params, {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()})
    flat = leaves(params)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)  # vlm: no embed lookup
    names = ["__".join(p) for p, _ in flatten_with_path(params)]
    return loss.item(), names, [np.zeros(p.shape, np.float32) if g is None else g.numpy()
                                for p, g in zip(flat, grads)]


def _jax_name(path):
    return "__".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path)


def _assert_grads_close(names, got, want, tol, what):
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what}: {name} max err {err:.3e} > {tol} * {scale:.3e}"


# ------------------------------------------------------------------ the loss
@pytest.mark.parametrize("mask", [None, "float", "bool"])
def test_softmax_cross_entropy_matches_jax(mask):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = None
    if mask is not None:
        m = rng.random((3, 7)) < 0.6
        m = m.astype(np.float32) if mask == "float" else m
    want = jlayers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), None if m is None else jnp.asarray(m))
    got = tlayers.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if m is None else torch.from_numpy(m))
    assert abs(float(got) - float(want)) <= CE_TOL


def test_softmax_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros((2, 3, 5))
    labels = torch.zeros((2, 3), dtype=torch.int32)
    assert float(tlayers.softmax_cross_entropy(logits, labels, torch.zeros((2, 3)))) == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_every_gradient_leaf_match_jax(family):
    arch = FAMILIES[family]
    jloss, jgrads = _jax_loss_and_grads(arch)
    tloss, names, tgrads = _port_loss_and_grads(arch)
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss), (tloss, jloss)
    assert names == [_jax_name(p) for p, _ in jgrads]
    _assert_grads_close(names, tgrads, [np.asarray(g) for _, g in jgrads], GRAD_TOL, family)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_gives_the_gradients_without_remat(family):
    arch = FAMILIES[family]
    loss0, names, g0 = _port_loss_and_grads(arch, remat=False)
    loss1, _, g1 = _port_loss_and_grads(arch, remat=True)
    assert abs(loss1 - loss0) <= REMAT_TOL * abs(loss0)
    _assert_grads_close(names, g1, g0, REMAT_TOL, family + " remat")


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_matches_jax_remat(family):
    arch = FAMILIES[family]
    jloss, jgrads = _jax_loss_and_grads(arch, remat=True)
    tloss, names, tgrads = _port_loss_and_grads(arch, remat=True)
    assert abs(tloss - jloss) <= LOSS_RTOL * abs(jloss)
    _assert_grads_close(names, tgrads, [np.asarray(g) for _, g in jgrads], GRAD_TOL,
                        family + " remat")


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_checkpoints_only_while_a_gradient_is_taken(family, monkeypatch):
    """With ``remat=True`` and grad mode on, inference (forward, prefill)
    never enters ``torch.utils.checkpoint``: nothing there requires grad.
    The loss over params that require grad enters it."""
    _, tcfg = _configs(FAMILIES[family], remat=True)
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def counted(*args, **kw):
        calls.append(1)
        return checkpoint(*args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    model = Model(tcfg)
    params = convert.from_jax(_params_np(FAMILIES[family]))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    assert torch.is_grad_enabled()
    model.forward(params, {"frames": batch["frames"], "tokens": batch["tokens"]}
                  if family == "encdec" else batch.get("inputs", batch.get("tokens")))
    cell = make_inputs(tcfg, ShapeCell("t", 8, 2, "prefill"), torch.Generator().manual_seed(0))
    model.prefill(params, cell["inputs"], cell["cache"])
    assert calls == []
    model.loss(tree_map(lambda p: p.requires_grad_(True), params), batch).backward()
    assert calls


def test_moe_aux_loss_enters_the_loss_and_its_gradient():
    """The load-balance term: the port's loss minus its plain cross entropy
    is 0.01 * aux, and the router's gradient matches JAX's (it is the leaf
    that the aux term reaches beyond the routed FFN)."""
    arch = FAMILIES["moe"]
    _, tcfg = _configs(arch)
    params = convert.from_jax(_params_np(arch))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    from repro_torch.models import transformer

    logits, aux = transformer.forward(tcfg, params, batch["tokens"])
    ce = tlayers.softmax_cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    assert float(aux) > 0
    torch.testing.assert_close(Model(tcfg).loss(params, batch), ce + 0.01 * aux,
                               atol=1e-7, rtol=0)


# -------------------------------------------------------------- make_inputs
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-76b", "seamless-m4t-large-v2",
                                  "xlstm-1.3b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_inputs_matches_jax_shapes_and_dtypes(arch, kind):
    jcfg, tcfg = _configs(arch)
    shape = ShapeCell("t", 8, 2, kind)
    want = jmake_inputs(jcfg, dataclasses.replace(JSHAPES[0], seq_len=8, global_batch=2,
                                                  kind=kind), jax.random.PRNGKey(0))
    got = make_inputs(tcfg, shape, torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    tflat = flatten_with_path(got)
    assert [_jax_name(p) for p, _ in jflat] == ["__".join(p) for p, _ in tflat]
    for (_, w), (name, g) in zip(jflat, tflat):
        assert tuple(g.shape) == tuple(w.shape), name
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
    if kind == "decode":
        assert int(got["cache"]["len"]) == 7
    if kind == "train":
        assert np.isfinite(float(Model(tcfg).loss(convert.from_jax(_params_np(arch)),
                                                  got["batch"])))


def test_shape_cells_are_the_jax_packages():
    assert [dataclasses.astuple(s) for s in SHAPES] == [dataclasses.astuple(s) for s in JSHAPES]


# ------------------------------------------------------- the plain switch
def test_plain_versions_is_this_threads_alone():
    seen = {}

    def other():
        seen["other"] = ops.plain_active()

    with ops.plain_versions():
        seen["inside"] = ops.plain_active()
        t = threading.Thread(target=other)
        t.start()
        t.join()
        with ops.plain_versions():
            pass
        seen["after_nested"] = ops.plain_active()
    seen["outside"] = ops.plain_active()
    assert seen == {"inside": True, "other": False, "after_nested": True, "outside": False}


def test_loss_counts_no_launch_and_keeps_autograd():
    arch = FAMILIES["ssm"]  # the mLSTM wrapper
    ops.reset_launches()
    _, names, grads = _port_loss_and_grads(arch)
    assert all(n == 0 for n in ops.launches().values())
    assert all(np.abs(g).max() > 0 for g in grads), names


def test_a_wrapper_on_an_unknown_device_still_raises():
    q = torch.zeros((1, 2, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q, q)
