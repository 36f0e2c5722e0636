"""The port's configs equal the JAX package's, field for field."""
import dataclasses

import pytest

import repro.configs as jcfg
import repro_torch.configs as tcfg


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        out[f.name] = getattr(cfg, f.name)
    out["hd"] = cfg.hd
    out["dtype"] = str(cfg.dtype).replace("torch.", "")
    out["cdtype"] = str(cfg.cdtype).replace("torch.", "")
    out["param_count"] = cfg.param_count()
    return out


def _jax_fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["hd"] = cfg.hd
    out["dtype"] = cfg.dtype.name
    out["cdtype"] = cfg.cdtype.name
    out["param_count"] = cfg.param_count()
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_qwen2_config_matches_jax(reduced):
    t = tcfg.get_config("qwen2-0.5b")
    j = jcfg.get_config("qwen2-0.5b")
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert _fields(t) == _jax_fields(j)


@pytest.mark.parametrize("reduced", [False, True])
def test_xlstm_config_matches_jax(reduced):
    t = tcfg.get_config("xlstm-1.3b")
    j = jcfg.get_config("xlstm-1.3b")
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert _fields(t) == _jax_fields(j)


@pytest.mark.parametrize("reduced", [False, True])
def test_zamba2_config_matches_jax(reduced):
    t = tcfg.get_config("zamba2-1.2b")
    j = jcfg.get_config("zamba2-1.2b")
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert _fields(t) == _jax_fields(j)
    assert "zamba2-1.2b" in tcfg.ARCH_IDS and "zamba2-1.2b" not in tcfg.NOT_PORTED


def test_unported_archs_raise_clearly():
    assert set(tcfg.NOT_PORTED) | set(tcfg.ARCH_IDS) == set(jcfg.ARCH_IDS)
    assert not set(tcfg.NOT_PORTED) & set(tcfg.ARCH_IDS)
    with pytest.raises(NotImplementedError, match="not ported"):
        tcfg.get_config("yi-34b")
    with pytest.raises(KeyError):
        tcfg.get_config("no-such-arch")
