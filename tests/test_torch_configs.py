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
@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_config_matches_jax(arch, reduced):
    t = tcfg.get_config(arch)
    j = jcfg.get_config(arch)
    if reduced:
        t, j = t.reduced(), j.reduced()
    assert _fields(t) == _jax_fields(j)
    assert arch not in tcfg.NOT_PORTED


def test_unported_archs_raise_clearly():
    # every arch of the JAX package is ported; an unknown one raises KeyError
    assert tcfg.NOT_PORTED == ()
    assert set(tcfg.ARCH_IDS) == set(jcfg.ARCH_IDS)
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")
