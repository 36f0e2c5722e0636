"""The port's placement and scale-out against the JAX package, on the CPU.

* ``param_spec``, ``data_spec`` and ``cache_spec`` on every leaf of the
  full-width archs' meta trees equal JAX's on its ``init_abstract`` tree,
  on (16, 16) and (2, 16, 16) meshes (duck-typed: both sides read only
  the axis names and sizes); the trees' paths, shapes and dtypes equal.
* The expert-parallel ``moe_ffn`` under 4 gloo ranks on a (2, 2) mesh
  equals JAX's shard-map ``moe_ffn`` under a (2, 2) Auto mesh of 4 host
  devices, in f32 to 1e-5 (output and aux loss): both plans, at capacity
  8.0 and 1.0 (pairs drop), gated and ungated, from plain and from DTensor
  arguments; on a (2, 1, 2) mesh with a "pod" axis, equal to the global
  path where nothing drops.
* A port-saved and a JAX-saved checkpoint restored by 4 gloo ranks onto
  (2, 2) and (4, 1) meshes: each rank's block equals the saved array's
  block at its mesh coordinate under JAX's spec, ``full_tensor()`` is
  bit-equal.
* Under the fake backend ``make_production_mesh`` has JAX's axes and
  shapes at 256 and 512 devices, and the dry-run's per-device argument
  bytes equal JAX's ``argument_size_in_bytes`` on a (2, 2) Auto mesh.

Everything that needs a process group runs in subprocesses started
together by one module fixture (JAX's 4 host devices, the fake backend,
4 gloo ranks over a ``file://`` store), so no test worker keeps a group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.distributed import checkpoint as jckpt
from repro.distributed import sharding as jshd
from repro.models.model import Model as JModel, input_specs as jinput_specs
from repro.models.moe import init_moe as jinit_moe
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.constraint import shard_activation, use_mesh
from repro_torch.models import moe
from repro_torch.models.model import Model, input_specs
from repro_torch.utils.tree import flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TIMEOUT = 240

MOE_TOL = 1e-5  # f32, both plans against JAX's shard_map
MOE_D, MOE_E, MOE_F, MOE_K = 32, 8, 64, 2
#: (B, S) → plan at D=32, E=8, F=64 on a (2, 2) mesh; capacity; activation
MOE_CASES = [(b, s, cf, act) for b, s in ((4, 8), (8, 32)) for cf in (8.0, 1.0)
             for act in ("silu", "gelu")]
MOE_PLANS = {(4, 8): "token-route", (8, 32): "weight-gather"}
ELASTIC_MESHES = ((2, 2), (4, 1))
BYTES_ARCHS = ("qwen2-0.5b", "kimi-k2-1t-a32b")
#: (name, seq, batch, kind) of the small dry-run cells
BYTES_CELLS = (("p", 64, 4, "prefill"), ("d", 64, 4, "decode"), ("t", 32, 4, "train"))
#: JAX's compiled prefill drops the cache's "len" (an int32 scalar the
#: prefill writes but never reads) from its arguments; the port counts it
PREFILL_UNUSED_LEN_BYTES = 4


def case_id(case):
    b, s, cf, act = case
    return f"{b}x{s}-cf{cf}-{act}"


class JMesh:
    """What JAX's sharding rules read of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


class TMesh:
    """What the port's sharding rules read of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(names)


PROD_MESHES = {"pod1": ((16, 16), ("data", "model")),
               "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _jflat(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", "?"))))
                        for p in path)
        out.append((name, tuple(leaf.shape), str(leaf.dtype)))
    return out


def _tflat(tree):
    return [("/".join(p), tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flatten_with_path(tree)]


# ------------------------------------------------------- specs (no process)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_and_specs_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    params = Model(cfg).init_abstract()
    assert all(x.is_meta for _, x in flatten_with_path(params))
    flat = _tflat(params)
    assert flat == _jflat(JModel(jcfg).init_abstract())
    for tag, (shape, names) in PROD_MESHES.items():
        tm, jm = TMesh(shape, names), JMesh(shape, names)
        for name, shp, _ in flat:
            assert shd.param_spec(name, shp, tm, cfg) == tuple(
                jshd.param_spec(name, shp, jm, jcfg)), (tag, name)
        for cell in SHAPES:
            if not cfg.supports_shape(cell):
                assert cfg.skip_reason(cell) == jcfg.skip_reason(cell)
                continue
            for key, sub in input_specs(cfg, cell).items():
                for path, leaf in flatten_with_path(sub):
                    name, shp = "/".join(path), tuple(leaf.shape)
                    if key == "cache":
                        want = jshd.cache_spec(name, shp, jm, jcfg, cell.global_batch)
                    else:
                        want = jshd.data_spec(shp, jm, jcfg, cell.global_batch)
                    got = shd.input_spec(name, shp, tm, cfg, cell, is_cache=key == "cache")
                    assert got == tuple(want), (tag, cell.name, key, name)
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "kimi-k2-1t-a32b", "zamba2-1.2b",
                                  "xlstm-1.3b", "seamless-m4t-large-v2", "internvl2-76b"])
def test_input_specs_equal_jax(arch):
    from repro.configs.base import ShapeCell as JShapeCell
    from repro_torch.configs.base import ShapeCell

    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    for name, seq, batch, kind in BYTES_CELLS:
        got = _tflat(input_specs(cfg, ShapeCell(name, seq, batch, kind)))
        assert got == _jflat(jinput_specs(jcfg, JShapeCell(name, seq, batch, kind)))
        assert all(t.is_meta for _, t in flatten_with_path(
            input_specs(cfg, ShapeCell(name, seq, batch, kind))))


def test_to_placements_pod_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = TMesh((2, 16, 16), ("pod", "data", "model"))
    assert shd.to_placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert shd.to_placements((None, None), mesh) == [Replicate()] * 3
    assert shd.local_shape((64, 7, 32), (("pod", "data"), None, "model"), mesh) == (2, 7, 2)


def test_placement_trees():
    from torch.distributed.tensor import Replicate

    from repro_torch.configs.base import ShapeCell
    from repro_torch.optim import adamw

    cfg = get_config("qwen2-0.5b").reduced()
    mesh = TMesh((2, 2), ("data", "model"))
    params = Model(cfg).init_abstract()
    placements = shd.shard_params(params, mesh, cfg)
    for path, leaf in flatten_with_path(params):
        got = placements
        for k in path:
            got = got[k]
        assert got == shd.to_placements(shd.param_spec("/".join(path), tuple(leaf.shape),
                                                       mesh, cfg), mesh)
    opt = shd.shard_opt_state(adamw.init_state(adamw.AdamWConfig(), params), placements, mesh)
    assert opt.step == [Replicate(), Replicate()] and opt.mu is placements
    cell = ShapeCell("d", 64, 4, "decode")
    specs = input_specs(cfg, cell)
    cache = shd.shard_inputs(specs["cache"], mesh, cfg, cell, is_cache=True)
    assert cache["k"] == shd.to_placements(shd.cache_spec(
        "k", tuple(specs["cache"]["k"].shape), mesh, cfg, 4), mesh)
    assert shd.shard_inputs(specs["tokens"], mesh, cfg, cell) == shd.to_placements(
        ("data", None), mesh)


def test_shard_activation_leaves_plain_tensors():
    x = torch.ones((4, 8))
    assert shard_activation(x, "data", None) is x  # no mesh
    with use_mesh(TMesh((2, 2), ("data", "model"))):
        assert shard_activation(x, "data", None) is x  # not a DTensor


def test_expert_parallel_needs_a_process_group():
    p = {"router": torch.zeros((MOE_D, MOE_E)), "wi": torch.zeros((MOE_E, MOE_D, 2, MOE_F)),
         "wo": torch.zeros((MOE_E, MOE_F, MOE_D))}
    with use_mesh(TMesh((1, 1), ("data", "model"))):
        with pytest.raises(RuntimeError, match="no process group"):
            moe.moe_ffn(p, torch.zeros((2, 4, MOE_D)), top_k=MOE_K)


# -------------------------------------------------------- process fixtures
JAX_MOE_CODE = r"""
import json, sys, numpy as np, jax
from jax.sharding import AxisType
from repro.models.moe import moe_ffn
out = sys.argv[1]
data = dict(np.load(out + "/moe_inputs.npz"))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
res = {}
for cid, (b, s, cf, act) in json.loads(sys.argv[2]).items():
    p = {k: data[f"{cid}/{k}"] for k in ("router", "wi", "wo")}
    with mesh:
        y, aux = jax.jit(lambda p, x: moe_ffn(p, x, top_k=2, capacity_factor=cf,
                                              activation=act))(p, data[f"{cid}/x"])
    res[f"{cid}/y"] = np.asarray(y)
    res[f"{cid}/aux"] = np.asarray(aux)
np.savez(out + "/moe_jax.npz", **res)
"""

JAX_BYTES_CODE = r"""
import json, sys, jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.configs.base import ShapeCell
from repro.launch.dryrun import _compile_cell
out = sys.argv[1]
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
nbytes = {}
for arch in json.loads(sys.argv[2]):
    cfg = get_config(arch).reduced()
    for name, seq, batch, kind in json.loads(sys.argv[3]):
        c, _, _, _ = _compile_cell(cfg, ShapeCell(name, seq, batch, kind), mesh, "float32")
        nbytes[f"{arch}/{kind}"] = int(c.memory_analysis().argument_size_in_bytes)
json.dump(nbytes, open(out + "/bytes_jax.json", "w"))
"""

FAKE_CODE = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import batch_axes, make_mesh, make_production_mesh, mesh_devices
out = sys.argv[1]
meshes = {}
for multi_pod, world in ((False, 256), (True, 512)):
    with dr.fake_process_group(world):
        m = make_production_mesh(multi_pod=multi_pod)
        meshes[str(world)] = {"names": list(m.mesh_dim_names), "shape": list(m.shape),
                              "devices": mesh_devices(m), "batch_axes": list(batch_axes(m)),
                              "device_type": m.device_type}
nbytes = {}
with dr.fake_process_group(4):
    mesh = make_mesh((2, 2), ("data", "model"))
    for arch in json.loads(sys.argv[2]):
        cfg = get_config(arch).reduced()
        for name, seq, batch, kind in json.loads(sys.argv[3]):
            cell = ShapeCell(name, seq, batch, kind)
            fn, args, k = dr.build_step(cfg, cell, "float32")
            _, outs = dr.count_cost(fn, args)
            nbytes[f"{arch}/{kind}"] = dr.step_bytes(cfg, cell, mesh, k, args, outs)[
                "argument_size_in_bytes"]
json.dump({"meshes": meshes, "bytes": nbytes}, open(out + "/fake.json", "w"))
"""

GLOO_CODE = r"""
import dataclasses, json, os, sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.constraint import shard_activation, use_mesh
from repro_torch.distributed.elastic import reshard, restore_elastic
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.utils.tree import flatten_with_path
out, rank = sys.argv[1], int(sys.argv[2])
cases, meshes = json.loads(sys.argv[3]), json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=f"file://{out}/store", rank=rank, world_size=4)
res = {}
try:
    data = dict(np.load(out + "/moe_inputs.npz"))
    mesh = make_mesh((2, 2), ("data", "model"))
    assert mesh.device_type == "cpu"
    for cid, (b, s, cf, act) in cases.items():
        p = convert.from_jax({k: data[f"{cid}/{k}"] for k in ("router", "wi", "wo")})
        x = torch.from_numpy(data[f"{cid}/x"])
        res[f"{cid}/plan"] = np.array(moe.choose_plan(
            b * s, p["wi"].numel() + p["wo"].numel(), 4, x.shape[-1], 2, 2))
        cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(), d_model=x.shape[-1],
                                  num_experts=p["router"].shape[-1])
        pd = reshard({"moe": p}, mesh, cfg)["moe"]
        assert [str(pl) for pl in pd["wi"].placements] == ["S(3)" if act == "silu" else "S(2)",
                                                           "S(0)"]
        xd = distribute_tensor(x, mesh, shd.to_placements(("data", None, None), mesh),
                               src_data_rank=None)
        with use_mesh(mesh):
            y, aux = moe.moe_ffn(p, x, top_k=2, capacity_factor=cf, activation=act)
            yd, auxd = moe.moe_ffn(pd, xd, top_k=2, capacity_factor=cf, activation=act)
        assert isinstance(yd, DTensor) and not isinstance(y, DTensor)
        res[f"{cid}/plain/y"], res[f"{cid}/plain/aux"] = y.numpy(), aux.numpy()
        res[f"{cid}/dtensor/y"], res[f"{cid}/dtensor/aux"] = yd.full_tensor().numpy(), auxd.numpy()
    whole = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh,
                              shd.to_placements((None, None), mesh), src_data_rank=None)
    with use_mesh(mesh):
        laid = shard_activation(whole, ("pod", "data"), "model")
    res["constraint/placements"] = np.array([str(pl) for pl in laid.placements])
    res["constraint/local"] = laid.to_local().numpy()
    res["constraint/coord"] = np.array(mesh.get_coordinate())
    pod_mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    for cid, (b, s, cf, act) in cases.items():
        if cf == 8.0:
            p = convert.from_jax({k: data[f"{cid}/{k}"] for k in ("router", "wi", "wo")})
            with use_mesh(pod_mesh):
                y, _ = moe.moe_ffn(p, torch.from_numpy(data[f"{cid}/x"]), top_k=2,
                                   capacity_factor=cf, activation=act)
            res[f"{cid}/pod/y"] = y.numpy()
    cfg = get_config("qwen2-0.5b").reduced()
    like = Model(cfg).init(torch.Generator().manual_seed(0))
    for shape in meshes:
        m = make_mesh(tuple(shape), ("data", "model"))
        for src in ("port", "jax"):
            step, tree, _ = restore_elastic(f"{out}/ckpt_{src}", like, m, cfg)
            for path, leaf in flatten_with_path(tree):
                key = f"{src}/{shape[0]}x{shape[1]}/{'/'.join(path)}"
                res[key + "/local"] = leaf.to_local().numpy()
                res[key + "/full"] = leaf.full_tensor().numpy()
                res[key + "/coord"] = np.array(m.get_coordinate())
finally:
    dist.destroy_process_group()
np.savez(f"{out}/rank{rank}.npz", **res)
"""


def _popen(code, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    cells = json.dumps(BYTES_CELLS)
    four = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    # the two that need no inputs start first, and run while the inputs are made
    procs = [_popen(JAX_BYTES_CODE, out, json.dumps(BYTES_ARCHS), cells, env_extra=four),
             _popen(FAKE_CODE, out, json.dumps(BYTES_ARCHS), cells)]
    experts = {act: jinit_moe(jax.random.PRNGKey(i), MOE_D, MOE_E, MOE_F, act, jnp.float32)
               for i, act in enumerate(("silu", "gelu"))}
    inputs = {}
    for i, case in enumerate(MOE_CASES):
        b, s, cf, act = case
        for k, v in experts[act].items():
            inputs[f"{case_id(case)}/{k}"] = np.asarray(v)
        inputs[f"{case_id(case)}/x"] = np.random.default_rng(i).standard_normal(
            (b, s, MOE_D)).astype(np.float32)
    np.savez(out / "moe_inputs.npz", **inputs)
    cfg = jget_config("qwen2-0.5b").reduced()
    jparams = JModel(cfg).init(jax.random.PRNGKey(3))
    jckpt.save_checkpoint(str(out / "ckpt_jax"), 7, jparams)
    tparams = Model(get_config("qwen2-0.5b").reduced()).init(torch.Generator().manual_seed(5))
    ckpt.save_checkpoint(str(out / "ckpt_port"), 9, tparams)

    cases = json.dumps({case_id(c): c for c in MOE_CASES})
    procs.append(_popen(JAX_MOE_CODE, out, cases, env_extra=four))
    procs += [_popen(GLOO_CODE, out, r, cases, json.dumps(ELASTIC_MESHES)) for r in range(4)]
    for proc in procs:
        _, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
    return {"out": out, "jax": dict(np.load(out / "moe_jax.npz")),
            "ranks": [dict(np.load(out / f"rank{r}.npz")) for r in range(4)],
            "fake": json.loads((out / "fake.json").read_text()),
            "bytes_jax": json.loads((out / "bytes_jax.json").read_text()),
            "saved": {"jax": jax.tree_util.tree_map(np.asarray, jparams),
                      "port": convert.to_numpy(tparams)}}


# ------------------------------------------------------------ the MoE plans
@pytest.mark.parametrize("variant", ["plain", "dtensor"])
@pytest.mark.parametrize("case", MOE_CASES, ids=case_id)
def test_expert_parallel_moe_matches_jax_shard_map(runs, case, variant):
    cid = case_id(case)
    want_y, want_aux = runs["jax"][f"{cid}/y"], runs["jax"][f"{cid}/aux"]
    for res in runs["ranks"]:
        assert str(res[f"{cid}/plan"]) == MOE_PLANS[case[:2]]
        np.testing.assert_allclose(res[f"{cid}/{variant}/y"], want_y, rtol=0, atol=MOE_TOL)
        np.testing.assert_allclose(res[f"{cid}/{variant}/aux"], want_aux, rtol=0, atol=MOE_TOL)


@pytest.mark.parametrize("case", [c for c in MOE_CASES if c[2] == 8.0], ids=case_id)
def test_expert_parallel_moe_on_a_pod_mesh_matches_the_global_path(runs, case):
    """On a (2, 1, 2) ("pod", "data", "model") mesh, where nothing drops,
    both plans give the global path's output. (JAX's shard-map plans give
    twice it there: they gather and sum the F-shards over "pod" too, which
    does not split them.)"""
    data = dict(np.load(runs["out"] / "moe_inputs.npz"))
    cid = case_id(case)
    p = convert.from_jax({k: data[f"{cid}/{k}"] for k in ("router", "wi", "wo")})
    want, _ = moe.moe_ffn(p, torch.from_numpy(data[f"{cid}/x"]), top_k=MOE_K,
                          capacity_factor=case[2], activation=case[3])
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[f"{cid}/pod/y"], want.numpy(), rtol=0, atol=MOE_TOL)


def test_capacity_one_drops_pairs_in_both_plans(runs):
    """At capacity 1.0 the sharded plans drop pairs: their output differs
    from the drop-free global path (so the cases above test the drops)."""
    data = dict(np.load(runs["out"] / "moe_inputs.npz"))
    for b, s in MOE_PLANS:
        cid = case_id((b, s, 1.0, "silu"))
        p = convert.from_jax({k: data[f"{cid}/{k}"] for k in ("router", "wi", "wo")})
        free, _ = moe.moe_ffn(p, torch.from_numpy(data[f"{cid}/x"]), top_k=MOE_K,
                              capacity_factor=8.0)
        assert np.abs(runs["jax"][f"{cid}/y"] - free.numpy()).max() > 1e-3


def test_shard_activation_redistributes_a_dtensor(runs):
    whole = np.arange(32.0).reshape(4, 8)
    for res in runs["ranks"]:
        assert list(res["constraint/placements"]) == ["S(0)", "S(1)"]
        d, m = res["constraint/coord"]
        assert np.array_equal(res["constraint/local"], whole[2 * d:2 * d + 2, 4 * m:4 * m + 4])


# ------------------------------------------------------------ elastic restore
def _block(arr, spec, shape, names, coord):
    """The block of ``arr`` at mesh coordinate ``coord`` under ``spec``."""
    sizes, pos = dict(zip(names, shape)), dict(zip(names, coord))
    idx = []
    for n, entry in zip(arr.shape, spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        k, r = 1, 0
        for a in axes:
            k, r = k * sizes[a], r * sizes[a] + pos[a]
        idx.append(slice(r * (n // k), (r + 1) * (n // k)))
    return arr[tuple(idx)]


@pytest.mark.parametrize("src", ["port", "jax"])
@pytest.mark.parametrize("shape", ELASTIC_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_elastic_restore_blocks_and_full_tensors(runs, src, shape):
    names = ("data", "model")
    jcfg = jget_config("qwen2-0.5b").reduced()
    saved = [(("/".join(p)), np.asarray(x)) for p, x in flatten_with_path(runs["saved"][src])]
    sharded = 0
    for rank, res in enumerate(runs["ranks"]):
        coord = (rank // shape[1], rank % shape[1])  # row-major rank layout
        for name, arr in saved:
            key = f"{src}/{shape[0]}x{shape[1]}/{name}"
            assert tuple(res[key + "/coord"]) == coord
            spec = tuple(jshd.param_spec(name, arr.shape, JMesh(shape, names), jcfg))
            want = _block(arr, spec, shape, names, coord)
            assert res[key + "/local"].shape == want.shape
            assert np.array_equal(res[key + "/local"], want), (rank, name)
            assert np.array_equal(res[key + "/full"], arr), (rank, name)
            sharded += want.size < arr.size
    assert sharded > 0  # some leaf is really split on this mesh


# ------------------------------------------------- meshes and dry-run bytes
@pytest.mark.parametrize("world", [256, 512])
def test_production_mesh_axes_under_fake_backend(runs, world):
    m = runs["fake"]["meshes"][str(world)]
    multi = world == 512
    assert m["names"] == (["pod", "data", "model"] if multi else ["data", "model"])
    assert m["shape"] == ([2, 16, 16] if multi else [16, 16])
    assert m["devices"] == world
    assert m["batch_axes"] == (["pod", "data"] if multi else ["data"])
    assert m["device_type"] == "cpu"


@pytest.mark.parametrize("arch", BYTES_ARCHS)
@pytest.mark.parametrize("kind", [c[3] for c in BYTES_CELLS])
def test_dryrun_argument_bytes_equal_jax(runs, arch, kind):
    got = runs["fake"]["bytes"][f"{arch}/{kind}"]
    want = runs["bytes_jax"][f"{arch}/{kind}"]
    if kind == "prefill":
        want += PREFILL_UNUSED_LEN_BYTES
    assert got == want
