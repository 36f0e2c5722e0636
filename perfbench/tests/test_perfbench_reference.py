"""The plain references against the port's models at a small size on the
CPU, and the control (the reference in fp8) failing where bfloat16 passes.

These tests import both the benchmark and the program; the references
themselves import nothing of the program."""
import ast
from pathlib import Path

import pytest
import torch

from perfbench.lib import check, spec, weights

DENSE = dict(name="small-dense", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128, activation="gelu",
             norm="layernorm", qkv_bias=True, mlp_bias=True, rope_theta=1e5, max_seq_len=64,
             param_dtype="float32", compute_dtype="float32")
#: the family's other branches: RMSNorm, gated SiLU, no MLP bias, tied head
DENSE_GATED = dict(DENSE, name="small-dense-gated", num_kv_heads=1, activation="silu",
                   norm="rmsnorm", mlp_bias=False, tie_embeddings=True, rope_theta=1e4)


def _port(model, seed):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    m = Model(ModelConfig(**model))
    ref = spec.reference(model["family"])
    return m, weights.make(m.init_abstract(), seed, "cpu", extra=getattr(ref, "WEIGHTS", None)), ref


@pytest.mark.parametrize("model", [DENSE, DENSE_GATED], ids=["dense", "dense-gated"])
def test_reference_matches_the_port_in_float32(model):
    m, params, ref = _port(model, 5)
    tokens = torch.randint(0, model["vocab_size"], (3, 20), generator=torch.Generator().manual_seed(0))
    want = m.forward(params, tokens)
    got = ref.logits(model, params, tokens, 0)
    assert got.shape == want.shape
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), (got - want).abs().max()
    # the positions asked for only
    assert torch.allclose(ref.logits(model, params, tokens, 15), got[:, 15:], atol=1e-5)


#: the port keeps these f32 whatever the param dtype
F32_LEAVES = ("a_log", "dt_bias", "d_skip")


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: (v if k in F32_LEAVES else _bf16(v)) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


@pytest.mark.parametrize("model", [DENSE, DENSE_GATED], ids=["dense", "dense-gated"])
def test_fp8_control_reads_far_above_bfloat16(model):
    """At each position of the same sequences, the gap below the float32
    reference's best of the token that bf16 (the port's forward) ranks
    first, and of the token fp8 (the control) ranks first: the control's
    smallest over three seeds is over three times bf16's largest."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model

    model = dict(model, d_model=128, d_ff=192, vocab_size=512)
    bf16 = Model(ModelConfig(**dict(model, param_dtype="bfloat16", compute_dtype="bfloat16")))
    low, high = [], []
    for seed in (1, 2, 3):
        _, params, ref = _port(model, seed)
        tokens = torch.randint(0, 512, (4, 24), generator=torch.Generator().manual_seed(seed))
        want = ref.logits(model, params, tokens, 8)
        best = want.max(-1).values
        for picks, out in ((bf16.forward(_bf16(params), tokens)[:, 8:], low),
                           (ref.logits(model, params, tokens, 8, mm=check.fp8_mm), high)):
            chosen = want.gather(-1, picks.argmax(-1, keepdim=True))[..., 0]
            out.append(float((best - chosen).max()))
    assert min(high) > 3 * max(low), (low, high)


def test_references_import_nothing_of_the_program():
    for path in sorted((spec.BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib", "flax"), (
                    path.name, n)
