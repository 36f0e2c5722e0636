"""The port's vectorised fleet controller against the scalar Python control
plane and against the JAX package's ``core/jax_controller.py``.

The first four tests mirror ``tests/test_jax_controller.py`` against the
port's own ``AIMDBatchOptimizer`` and ``SmartMonitor``. The rest hold each
function to its JAX counterpart on the same numpy inputs: bit for bit
(``np.testing.assert_array_equal``, NaN in the same places), since both
compute the same float32 operations in the same order. Every scatter
names distinct endpoints: a repeated one is not defined in either package.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_controller as jc
from repro_torch.core import (
    AIMDBatchOptimizer,
    MonitorConfig,
    OptimizerConfig,
    SLAConfig,
    SmartMonitor,
)
from repro_torch.core import fleet_controller as fc


def test_aimd_step_matches_scalar():
    n = 16
    rng = np.random.default_rng(0)
    slo = np.full(n, 1.0, np.float32)
    state = fc.init_fleet(n, n_buckets=8, window=32, e2e_window=64, device="cpu")
    scalars = []
    for _ in range(n):
        sla = SLAConfig(slo_target=1.0)
        mon = SmartMonitor(MonitorConfig(window_size=64, window_horizon=1e12,
                                         e2e_horizon=1e12), sla)
        scalars.append((mon, AIMDBatchOptimizer(OptimizerConfig(), sla, mon)))
    # feed identical observations to both
    for step in range(50):
        ep = int(rng.integers(0, n))
        lat = float(rng.uniform(0.05, 1.5))
        was_to = bool(rng.random() < 0.3)
        state = fc.record_e2e(state, torch.tensor(ep), torch.tensor(lat, dtype=torch.float32))
        state = fc.record_dispatch(state, torch.tensor(ep), torch.tensor(was_to))
        mon, _ = scalars[ep]
        mon.record_e2e(lat, now=float(step))
        mon.record_dispatch(2, "timeout" if was_to else "full")
    state2 = fc.aimd_step(state, torch.from_numpy(slo))
    for i, (_, opt) in enumerate(scalars):
        opt.update(now=1e9)  # horizon large → no eviction difference
        assert float(state2.max_bs[i]) == pytest.approx(opt.max_bs_raw, rel=1e-5), i
    assert int(state2.disp_count.sum()) == 0  # counters reset


def test_timeout_step_matches_equation():
    state = fc.init_fleet(4, n_buckets=8, window=16, initial_max_bs=8.0, device="cpu")
    for _ in range(4):  # endpoint 0, bucket 2 (the probe for queue_len 2): 0.3
        state = fc.record_upstream(state, torch.tensor(0), torch.tensor(2),
                                   torch.tensor(0.3, dtype=torch.float32))
    queue_len = torch.tensor([2, 0, 1, 8], dtype=torch.int32)
    frt = torch.tensor([0.1, 0.0, 0.0, 0.0])
    slo = torch.tensor([1.0, 1.0, 1.0, 1.0])
    dispatch, to = fc.timeout_step(state, queue_len, frt, slo)
    assert float(to[0]) == pytest.approx(0.6, abs=1e-6)  # (1.0 - 0.3) - 0.1
    assert not bool(dispatch[0])
    assert not bool(dispatch[1])  # empty queue
    # no latency data anywhere → est 0 → TO = SLO > 0, queue < max
    assert not bool(dispatch[2])
    assert float(to[2]) == pytest.approx(1.0, abs=1e-6)
    assert bool(dispatch[3])  # queue_len == max_bs → 'full'


def test_masked_percentile_ignores_nans():
    nan = float("nan")
    p = fc._masked_percentile(torch.tensor([[1.0, nan, 3.0, 2.0], [nan] * 4]), 95.0)
    assert float(p[0]) == 3.0
    assert bool(torch.isnan(p[1]))


def test_effective_max_bs_floor():
    state = dataclasses.replace(fc.init_fleet(2, 4, device="cpu"),
                                max_bs=torch.tensor([1.6, 7.2]))
    assert fc.effective_max_bs(state).tolist() == [1, 7]


# ------------------------------------------------------------ against JAX
N, B, W, WE = 24, 8, 16, 32


def _state_np(rng):
    """A state with partly filled rings (NaN = empty), mixed counters."""
    ring = rng.uniform(0.01, 2.0, (N, B, W)).astype(np.float32)
    ring[rng.random((N, B, W)) < 0.5] = np.nan
    ring[:3] = np.nan  # endpoints with no sample in any bucket
    ring[3, :5] = np.nan  # empty probe buckets, others filled
    e2e = rng.uniform(0.05, 1.5, (N, WE)).astype(np.float32)
    e2e[rng.random((N, WE)) < 0.4] = np.nan
    e2e[:2] = np.nan
    disp = rng.integers(0, 6, N).astype(np.int32)
    return dict(max_bs=rng.uniform(1.0, 20.0, N).astype(np.float32), ring=ring,
                ring_pos=rng.integers(0, W, (N, B)).astype(np.int32), e2e_ring=e2e,
                e2e_pos=rng.integers(0, WE, N).astype(np.int32),
                to_count=np.minimum(disp, rng.integers(0, 6, N)).astype(np.int32),
                disp_count=disp)


def _pair(arrays):
    return (jc.FleetState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            fc.FleetState(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()}))


def _same(t, j, what=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def _same_state(ts, js):
    for f in dataclasses.fields(fc.FleetState):
        _same(getattr(ts, f.name), getattr(js, f.name), f.name)


def test_init_fleet_matches_jax():
    _same_state(fc.init_fleet(5, 3, window=7, e2e_window=9, initial_max_bs=2.5, device="cpu"),
                jc.init_fleet(5, 3, window=7, e2e_window=9, initial_max_bs=2.5))


def test_init_fleet_needs_a_device():
    # the state lives where the caller says: no default puts it on the CPU
    with pytest.raises(TypeError):
        fc.init_fleet(2, 4)
    assert fc.init_fleet(2, 4, device="cpu").ring.device.type == "cpu"


@pytest.mark.parametrize("q", [50.0, 90.0, 95.0, 99.0, 100.0])
def test_masked_percentile_matches_jax(q):
    rng = np.random.default_rng(int(q))
    x = rng.uniform(0.0, 3.0, (40, 33)).astype(np.float32)
    x[rng.random(x.shape) < 0.6] = np.nan
    x[0], x[1, 1:] = np.nan, np.nan  # an empty row, a row of one sample
    _same(fc._masked_percentile(torch.from_numpy(x), q), jc._masked_percentile(jnp.asarray(x), q))
    assert torch.isnan(torch.sort(torch.tensor([3.0, float("nan"), 1.0, 2.0])).values[-1])


def test_records_match_jax_and_leave_the_input_state():
    rng = np.random.default_rng(1)
    arrays = _state_np(rng)
    js, ts = _pair(arrays)
    ts0 = ts
    ep = rng.permutation(N)[:10].astype(np.int32)  # distinct endpoints
    bucket = rng.integers(0, B, 10).astype(np.int32)
    lat = rng.uniform(0.01, 2.0, 10).astype(np.float32)
    was_to = rng.random(10) < 0.5
    for jfn, tfn, args in ((jc.record_upstream, fc.record_upstream, (ep, bucket, lat)),
                           (jc.record_e2e, fc.record_e2e, (ep, lat)),
                           (jc.record_dispatch, fc.record_dispatch, (ep, was_to))):
        js = jfn(js, *map(jnp.asarray, args))
        ts = tfn(ts, *map(torch.from_numpy, args))
        _same_state(ts, js)
    # one endpoint at a time, as scalars, wraps the ring positions
    for i in range(W + 3):
        js = jc.record_upstream(js, jnp.asarray(5), jnp.asarray(i % B), jnp.float32(i))
        ts = fc.record_upstream(ts, torch.tensor(5), torch.tensor(i % B), torch.tensor(float(i)))
    _same_state(ts, js)
    for f in dataclasses.fields(fc.FleetState):  # pure: the input state is untouched
        np.testing.assert_array_equal(getattr(ts0, f.name).numpy(), arrays[f.name], f.name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeout_and_aimd_steps_match_jax(seed):
    rng = np.random.default_rng(10 + seed)
    js, ts = _pair(_state_np(rng))
    queue_len = rng.integers(0, B + 4, N).astype(np.int32)
    queue_len[:4] = 0
    frt = rng.uniform(0.0, 1.0, N).astype(np.float32)
    slo = rng.uniform(0.3, 4.0, N).astype(np.float32)
    jd, jto = jc.timeout_step(js, jnp.asarray(queue_len), jnp.asarray(frt), jnp.asarray(slo))
    td, tto = fc.timeout_step(ts, *map(torch.from_numpy, (queue_len, frt, slo)))
    _same(td, jd, "dispatch_now")
    _same(tto, jto, "timeout")
    assert 0 < int(td.sum()) < N
    kw = dict(to_thresh=0.5, compliance_factor=0.7, inc_step=2.0, dec_mult=0.75, max_cap=12.0)
    js2 = jc.aimd_step(js, jnp.asarray(slo), **kw)
    ts2 = fc.aimd_step(ts, torch.from_numpy(slo), **kw)
    _same_state(ts2, js2)
    _same(fc.effective_max_bs(ts2), jc.effective_max_bs(js2), "effective_max_bs")
    grew = ts2.max_bs > ts.max_bs
    assert 0 < int(grew.sum()) < N  # some endpoints grew, some shrank
