"""The hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip without
one. Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.
The file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import mlstm_attention as tml
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tssd

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_TOL = {k: 2 * v for k, v in TOL.items()}  # the signed denominator amplifies rounding
SSD_TOL = {k: 4 * v for k, v in TOL.items()}  # long products of decays amplify rounding


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(getattr(torch, dtype))
            for s in shapes]


def _close(got, want, dtype, tol=TOL):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               atol=tol[dtype], rtol=tol[dtype])


#: max |err| / rms of each output row, as ``chip_smoke.SCALED_TOL``: over
#: thousands of keys the outputs are ~sqrt(e / Sk), below TOL's absolute part
SCALED_TOL = {"float32": 1e-3, "bfloat16": 0.1}


def _close_to_scale(got, want, dtype):
    got, want = got.float().cpu(), want.float().cpu()
    err = (got - want).abs().amax(-1) / want.pow(2).mean(-1).sqrt()
    assert float(err.max()) <= SCALED_TOL[dtype], float(err.max())


def _ssd_plain_f32(x, dt, a, b, c, chunk):
    """The SSD kernel's plain version on the same values in f32, rounded to
    x's dtype once at the end. The kernel computes in f32, as the TPU kernel
    does; the plain version run in bf16 rounds its (Q × Q) weights to bf16
    first (as the JAX model's ``ssd_chunked`` does), an error larger than
    the kernel's own."""
    return tref.ssd_scan(x.float(), dt, a, b.float(), c.float(), chunk=chunk).to(x.dtype)


def _mlstm_gates(seed, b, s, h, device):
    rng = np.random.default_rng(seed)
    log_i = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32) * 0.5)
    f_pre = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32) + 2.0)
    return log_i.to(device), torch.nn.functional.logsigmoid(f_pre).to(device)


def _ssd_views(seed, b, s, h, p, n, dtype, device):
    """x, dt, a, B and C as the model hands them over: x, B and C views of
    one conv output (B, S, H·P + 2N)."""
    rng = np.random.default_rng(seed)
    conv = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n)).astype(np.float32))
    conv = conv.to(getattr(torch, dtype)).to(device)
    x = conv[..., :h * p].reshape(b, s, h, p)
    bb, cc = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32))).to(device)
    a = -torch.linspace(1.0, 16.0, h, device=device)
    return x, dt, a, bb, cc


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelsOnCard:
    @pytest.mark.parametrize("b,s,hq,hkv,d,dtype,causal", [
        (2, 200, 8, 2, 64, "float32", True),
        (2, 200, 8, 2, 64, "float32", False),
        (32, 128, 14, 2, 64, "bfloat16", True),
        (2, 24, 4, 2, 16, "float32", True),
    ])
    def test_flash_kernel_matches_plain(self, cuda, b, s, hq, hkv, d, dtype, causal):
        q, k, v = (t.to(cuda) for t in _inputs(
            s, [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype))
        tops.reset_launches()
        got = tops.flash_attention(q, k, v, causal=causal)
        want = tref.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert tops.launches()["flash_attention"] == 1
        _close(got, want, dtype)

    @pytest.mark.parametrize("s", [1, 24, 200, 257])
    @pytest.mark.parametrize("d", [16, 32, 128])
    def test_flash_kernel_bf16_edges(self, cuda, s, d):
        """The tensor-core kernel at its edges: ragged and one-row tiles,
        every head dim, G = 1, 2 and 7, causal and full."""
        for hq, hkv in ((4, 4), (4, 2), (14, 2)):
            q, k, v = (t.to(cuda) for t in _inputs(
                s + d + hq, [(2, s, hq, d), (2, s, hkv, d), (2, s, hkv, d)], "bfloat16"))
            for causal in (True, False):
                got = tops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                _close(got, tref.flash_attention(q, k, v, causal=causal), "bfloat16")

    @pytest.mark.parametrize("b,hq,hkv", [(1, 14, 2), (32, 14, 2), (1, 32, 32), (32, 32, 32)])
    def test_decode_kernel_bf16_lengths_across_splits(self, cuda, b, hq, hkv):
        """Buckets 1 and 32 at qwen2's (G = 7) and Zamba2's (G = 1) heads,
        with the planned split and forced ones: lengths 0, 1, a split
        boundary ± 1 and S_max, and per-row lengths that put the rows of
        one batch in different splits. Held to the plain split-and-merge rendering (a
        length of 0 gives zeros, as the TPU kernel) and, where every
        length is positive, to the plain version."""
        s_max, d = 144, 64
        q, kc, vc = (t.to(cuda) for t in _inputs(
            b + hq, [(b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)], "bfloat16"))
        per_row = torch.tensor([(7 + 37 * i) % (s_max + 1) for i in range(b)],
                               dtype=torch.int32, device=cuda)
        cases = [(torch.tensor([n], dtype=torch.int32, device=cuda), sl)
                 for sl in (None, 18, 48)
                 for n in (0, 1, (sl or s_max) - 1, sl or s_max, (sl or s_max) + 1, s_max)]
        cases += [(per_row, sl) for sl in (None, 18, 48, 72)]
        for lens, sl in cases:
            split_len = sl or tdec.split_plan(b, hkv, s_max)[1]
            got = tdec.decode_attention_fwd(q, kc, vc, lens, split_len=sl)
            torch.cuda.synchronize()
            _close(got, tref.decode_attention_split(q, kc, vc, lens, split_len), "bfloat16")
            if int(lens.min()) > 0:
                _close(got, tref.decode_attention(q, kc, vc, lens), "bfloat16")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("hq,hkv,d", [(64, 8, 112), (96, 8, 192)])  # kimi-k2, nemotron-4
    def test_attention_kernels_at_head_dims_112_and_192(self, cuda, hq, hkv, d, dtype):
        """Flash at prompt 128 and S = 1 and 77, causal and full; decode at
        S_max 144 with lengths 0, 1, ragged per row and full, the planned
        split and a forced one (a length of 0 held to the split rendering,
        which gives zeros as the TPU kernel does)."""
        for b, s, causal in ((2, 128, True), (2, 1, True), (2, 77, False)):
            q, k, v = (t.to(cuda) for t in _inputs(
                s + d, [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype))
            tops.reset_launches()
            got = tops.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert tops.launches()["flash_attention"] == 1
            _close(got, tref.flash_attention(q, k, v, causal=causal), dtype)
        b, s_max = 4, 144
        q, kc, vc = (t.to(cuda) for t in _inputs(
            d, [(b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)], dtype))
        per_row = torch.tensor([0, 1, 77, 144], dtype=torch.int32, device=cuda)
        for lens in [torch.tensor([n], dtype=torch.int32, device=cuda) for n in (0, 1, 97, 144)
                     ] + [per_row]:
            for sl in (None, 48):
                split_len = sl or tdec.split_plan(b, hkv, s_max)[1]
                got = tdec.decode_attention_fwd(q, kc, vc, lens, split_len=sl)
                torch.cuda.synchronize()
                _close(got, tref.decode_attention_split(q, kc, vc, lens, split_len), dtype)
                if int(lens.min()) > 0:
                    _close(got, tref.decode_attention(q, kc, vc, lens), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [64, 192])
    @pytest.mark.parametrize("sq,sk", [(128, 4096), (200, 200), (24, 257), (257, 24), (1, 130)])
    def test_flash_kernel_sq_ne_sk_and_full(self, cuda, sq, sk, d, dtype):
        """Sq query rows over Sk keys (the encoder-decoder's cross-attention
        is 128 over 4096), full and causal (top-left aligned, as the TPU
        kernel masks), at G = 1 and 2."""
        for hq, hkv in ((4, 4), (4, 2)):
            q, k, v = (t.to(cuda) for t in _inputs(
                sq + sk + d + hkv, [(2, sq, hq, d), (2, sk, hkv, d), (2, sk, hkv, d)], dtype))
            for causal in (False, True):
                tops.reset_launches()
                got = tops.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                assert tops.launches()["flash_attention"] == 1
                want = tref.flash_attention(q, k, v, causal=causal)
                _close(got, want, dtype)
                _close_to_scale(got, want, dtype)

    def test_decode_kernel_ignores_padding_content_bf16_split(self, cuda):
        q, kc, vc = (t.to(cuda) for t in _inputs(
            1, [(2, 1, 14, 64), (2, 144, 2, 64), (2, 144, 2, 64)], "bfloat16"))
        lens = torch.tensor([40], dtype=torch.int32, device=cuda)
        a = tdec.decode_attention_fwd(q, kc, vc, lens, split_len=24)  # splits 2-5 past 40
        kc[:, 40:], vc[:, 40:] = 999.0, -999.0
        b = tdec.decode_attention_fwd(q, kc, vc, lens, split_len=24)
        torch.cuda.synchronize()
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    @pytest.mark.parametrize("b,s,hq,hkv,d,dtype", [
        (32, 144, 14, 2, 64, "bfloat16"),
        (4, 640, 4, 4, 32, "float32"),
        (3, 100, 32, 2, 32, "float32"),    # G = 16: eight chunks of 2 q heads
        (2, 144, 32, 32, 128, "bfloat16"),
    ])
    def test_decode_kernel_matches_plain_per_row_lengths(self, cuda, b, s, hq, hkv, d, dtype):
        q, kc, vc = (t.to(cuda) for t in _inputs(
            s, [(b, 1, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype))
        lens = torch.from_numpy(np.random.default_rng(b).integers(1, s + 1, b)
                                .astype(np.int32)).to(cuda)
        got = tops.decode_attention(q, kc, vc, lens)
        want = tref.decode_attention(q, kc, vc, lens)
        torch.cuda.synchronize()
        _close(got, want, dtype)

    def test_decode_kernel_ignores_padding_content(self, cuda):
        q, kc, vc = (t.to(cuda) for t in _inputs(
            0, [(2, 1, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32)], "float32"))
        lens = torch.tensor([40], dtype=torch.int32, device=cuda)
        a = tops.decode_attention(q, kc, vc, lens)
        kc[:, 40:], vc[:, 40:] = 999.0, -999.0
        b = tops.decode_attention(q, kc, vc, lens)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("b,s,h,d,dtype", [
        (2, 128, 4, 1024, "bfloat16"),  # xLSTM-1.3B's mLSTM head dim
        (2, 40, 4, 1024, "float32"),
        (2, 257, 2, 32, "float32"),     # ragged S, the reduced model's head dim
        (1, 200, 4, 64, "float32"),
    ])
    def test_mlstm_kernel_matches_plain(self, cuda, b, s, h, d, dtype):
        q, k, v = (t.to(cuda) for t in _inputs(s + d, [(b, s, h, d)] * 3, dtype))
        rng = np.random.default_rng(d)
        log_i = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32) * 0.5)
        f_pre = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32) + 2.0)
        log_i, log_f = log_i.to(cuda), torch.nn.functional.logsigmoid(f_pre).to(cuda)
        tops.reset_launches()
        got = tops.mlstm_attention(q, k, v, log_i, log_f)
        want = tref.mlstm_attention(q, k, v, log_i, log_f)
        torch.cuda.synchronize()
        assert tops.launches()["mlstm_attention"] == 1
        _close(got, want, dtype, MLSTM_TOL)

    @pytest.mark.parametrize("b,s,h,p,n,chunk,dtype", [
        (32, 128, 64, 64, 64, 128, "bfloat16"),  # Zamba2-1.2B's serving shape
        (2, 100, 4, 64, 64, 32, "bfloat16"),     # ragged S, several chunks
        (2, 100, 4, 64, 64, 32, "float32"),
        (2, 24, 8, 16, 16, 8, "float32"),        # the reduced model's shape
        (1, 33, 2, 128, 128, 128, "float32"),    # the largest P and N
        (2, 40, 3, 8, 32, 16, "float32"),
    ])
    def test_ssd_kernel_matches_plain(self, cuda, b, s, h, p, n, chunk, dtype):
        rng = np.random.default_rng(s + p)
        x, bb, cc = (t.to(cuda) for t in _inputs(s, [(b, s, h, p), (b, s, n), (b, s, n)],
                                                   dtype))
        dt = torch.nn.functional.softplus(
            torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32))).to(cuda)
        a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(np.float32)) * 0.3)
        a = a.to(cuda)
        tops.reset_launches()
        got = tops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
        want = _ssd_plain_f32(x, dt, a, bb, cc, chunk)
        torch.cuda.synchronize()
        assert tops.launches()["ssd_scan"] == 1
        _close(got, want, dtype, SSD_TOL)

    @pytest.mark.parametrize("s", [1, 17, 128, 200, 257])
    @pytest.mark.parametrize("d", [32, 64, 128, 256, 512, 1024])
    def test_mlstm_kernel_bf16_edges(self, cuda, s, d):
        """The tensor-core kernel at its edges and every D it dispatches:
        one row, ragged and several 64-row query tiles, one D-slice (32, 64,
        128) and clusters of two, four and eight (256, 512, 1024); held to
        the plain version and to its own arithmetic rendered plainly
        (D-sliced scores, w as bf16 hi + lo)."""
        b, h = 2, 2
        q, k, v = (t.to(cuda) for t in _inputs(s + d, [(b, s, h, d)] * 3, "bfloat16"))
        log_i, log_f = _mlstm_gates(s * d, b, s, h, cuda)
        tops.reset_launches()
        got = tops.mlstm_attention(q, k, v, log_i, log_f)
        torch.cuda.synchronize()
        assert tops.launches()["mlstm_attention"] == 1
        _close(got, tref.mlstm_attention(q, k, v, log_i, log_f), "bfloat16", MLSTM_TOL)
        _close(got, tref.mlstm_attention_sliced(q, k, v, log_i, log_f, slice_cols=tml.SLICE),
               "bfloat16")

    @pytest.mark.parametrize("pn", [16, 64, 128])
    @pytest.mark.parametrize("chunk", [32, 128])
    def test_ssd_kernel_bf16_edges(self, cuda, pn, chunk):
        """The tensor-core kernel at P = N in {16, 64, 128}, chunks 32 and
        128: one row, ragged S in one chunk and in several, x/B/C as strided
        views of one conv output; held to the plain version in f32 and to
        its own arithmetic rendered plainly (C·Bᵀ per group, w as hi + lo)."""
        for s in (1, 70, 300):
            x, dt, a, bb, cc = _ssd_views(s + pn, 2, s, 3, pn, pn, "bfloat16", cuda)
            tops.reset_launches()
            got = tops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
            torch.cuda.synchronize()
            assert tops.launches()["ssd_scan"] == 1
            _close(got, _ssd_plain_f32(x, dt, a, bb, cc, chunk), "bfloat16", SSD_TOL)
            _close(got, tref.ssd_scan_grouped(x, dt, a, bb, cc, chunk=chunk), "bfloat16")

    @pytest.mark.parametrize("b,s,chunk,heads", [(66, 128, 128, 4), (132, 128, 128, 8),
                                                 (44, 70, 32, 2), (66, 70, 32, 4),
                                                 (2, 300, 128, 1)])
    def test_ssd_kernel_heads_a_block(self, cuda, b, s, chunk, heads):
        """1, 2, 4 and 8 heads a block, as the plan picks them by batch size,
        H = 5 not a multiple of them: one chunk, and several with the
        block's heads' states carried in shared memory."""
        q = min(chunk, max(s, 8))
        assert tssd.heads_per_block(b, 5, 64, 64, q, -(-s // q)) == heads
        x, dt, a, bb, cc = _ssd_views(heads, b, s, 5, 64, 64, "bfloat16", cuda)
        tops.reset_launches()
        got = tops.ssd_scan(x, dt, a, bb, cc, chunk=chunk)
        torch.cuda.synchronize()
        assert tops.launches()["ssd_scan"] == 1
        _close(got, _ssd_plain_f32(x, dt, a, bb, cc, chunk), "bfloat16", SSD_TOL)
        _close(got, tref.ssd_scan_grouped(x, dt, a, bb, cc, chunk=chunk), "bfloat16")

    def test_ssd_kernel_reads_strided_views(self, cuda):
        """x, B and C as the model hands them over: views of one conv output."""
        b, s, h, p, n = 2, 50, 4, 16, 32
        rng = np.random.default_rng(1)
        conv = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * n))
                                .astype(np.float32)).to(cuda)
        x = conv[..., :h * p].reshape(b, s, h, p)
        bb, cc = conv[..., h * p:h * p + n], conv[..., h * p + n:]
        dt = torch.from_numpy(rng.random((b, s, h)).astype(np.float32)).to(cuda)
        a = -torch.linspace(1.0, 4.0, h, device=cuda)
        got = tops.ssd_scan(x, dt, a, bb, cc, chunk=16)
        want = tref.ssd_scan(x.contiguous(), dt, a, bb.contiguous(), cc.contiguous(), chunk=16)
        torch.cuda.synchronize()
        _close(got, want, "float32", SSD_TOL)


@pytest.mark.cuda
class TestEngineOnCard:
    """The engine's card-only properties: each replica on its own stream,
    a decode past ``max_len`` as the JAX engine does it, and each key's
    prefill and decode loop replayed as a CUDA graph (CPU parity with the
    JAX engine is in ``tests/test_torch_engine.py``, the graph bookkeeping
    on the CPU in ``tests/test_torch_graphs.py``)."""

    @staticmethod
    def _engine(arch, device, params=None, **kw):
        from repro_torch.configs import get_config
        from repro_torch.serving.engine import EngineConfig, InferenceEngine

        ecfg = EngineConfig(**{**dict(batch_buckets=(1, 2), prompt_buckets=(16,),
                                      max_len=20, gen_len=8), **kw})
        return InferenceEngine(get_config(arch).reduced(), ecfg, params=params, seed=0,
                               device=device)

    @pytest.mark.parametrize("arch", ["qwen2-0.5b", "zamba2-1.2b"])
    def test_decode_past_max_len_matches_the_cpu(self, cuda, arch):
        """plen + gen_len - 1 = 23 > max_len = 20: the card gives the CPU's
        tokens (no device-side assert), and so does the per-token loop."""
        card = self._engine(arch, cuda)
        cpu = self._engine(arch, "cpu", params=_tree_to(card.params, "cpu"))
        prompts = np.random.default_rng(0).integers(
            0, card.cfg.vocab_size, (2, 16)).astype(np.int32)
        got, _ = card.generate(prompts)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got, cpu.generate(prompts)[0])
        per_token = self._engine(arch, cuda, params=card.params, fused_decode=False)
        np.testing.assert_array_equal(per_token.generate(prompts)[0], got)

    def test_replica_does_not_wait_for_another_replicas_stream(self, cuda):
        import time

        from repro_torch.serving.engine import ReplicaPool

        eng = self._engine("qwen2-0.5b", cuda, max_len=32)
        pool = ReplicaPool(eng.cfg, eng.ecfg, n_replicas=2, params=eng.params, device=cuda)
        r0, r1 = pool.replicas
        assert r0.stream is not None and r0.stream != r1.stream
        prompts = np.random.default_rng(1).integers(0, eng.cfg.vocab_size,
                                                    (2, 16)).astype(np.int32)
        r1.generate(prompts)
        alone, _ = r1.generate(prompts)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(100_000_000)
        end.record()
        end.synchronize()
        cycles = int(2000.0 * 1e8 / start.elapsed_time(end))  # ~2 s
        with torch.cuda.stream(r0.stream):
            torch.cuda._sleep(cycles)
        t0 = time.monotonic()
        got, _ = r1.generate(prompts)
        took = time.monotonic() - t0
        held = not r0.stream.query()
        r0.stream.synchronize()
        assert held, "replica 0's sleep ended before replica 1 returned"
        assert took < 1.0, f"replica 1 took {took:.3f} s beside a 2 s sleep on replica 0"
        np.testing.assert_array_equal(got, alone)

    def test_concurrent_pool_callers_overlap_on_both_replicas(self, cuda):
        """Threads calling ``ReplicaPool.generate`` at once land on both
        replicas (each on its own stream), get the tokens one engine gives
        alone, and every kernel launch is counted."""
        import threading

        from repro_torch.serving.engine import ReplicaPool

        eng = self._engine("qwen2-0.5b", cuda, max_len=32)
        pool = ReplicaPool(eng.cfg, eng.ecfg, n_replicas=2, params=eng.params, device=cuda)
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, eng.cfg.vocab_size, (2, 16)).astype(np.int32)
                   for _ in range(8)]
        want = [eng.generate(p)[0] for p in prompts]
        got, replicas = [None] * 8, [None] * 8

        def call(i):
            got[i], timing = pool.generate(prompts[i])
            replicas[i] = timing["replica"]

        tops.reset_launches()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert set(replicas) == {0, 1}
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        steps = sum(r.decode_steps for r in pool.replicas)
        assert tops.launches()["flash_attention"] == eng.cfg.num_layers * 8
        assert tops.launches()["decode_attention"] == eng.cfg.num_layers * steps


    @pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
    def test_reduced_moe_card_matches_cpu(self, cuda, arch):
        """Reduced MoE models in f32: prefill and 8 teacher-forced decode
        steps on the card (kernels) give the CPU's logits to 1e-4, with the
        attention kernels launched once a layer a prefill or step; the
        engine's graphs give the per-token eager loop's tokens."""
        from repro_torch.configs import get_config
        from repro_torch.models.model import Model

        cfg = get_config(arch).reduced()
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
        forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 2, 1)))
        outs = {}
        for dev in ("cpu", cuda):
            tops.reset_launches()
            p = _tree_to(params, dev)
            cache = model.init_cache(2, 32, device=dev)
            logits, cache = model.prefill(p, prompt.to(dev), cache)
            seq = [logits]
            for i in range(8):
                logits, cache = model.decode_step(p, forced[i].to(dev), cache)
                seq.append(logits)
            outs[str(dev)] = torch.cat(seq, dim=1).cpu()
        assert tops.launches()["flash_attention"] == cfg.num_layers
        assert tops.launches()["decode_attention"] == 8 * cfg.num_layers
        torch.testing.assert_close(outs["cuda"], outs["cpu"], atol=1e-4, rtol=1e-4)
        eng = self._engine(arch, cuda)
        ref = self._engine(arch, cuda, params=eng.params, fused_decode=False)
        for n in (2, 2, 1, 1):
            prompts = rng.integers(0, cfg.vocab_size, (n, 16)).astype(np.int32)
            np.testing.assert_array_equal(eng.generate(prompts)[0], ref.generate(prompts)[0])
        assert eng.graph_replays == 2 * 2

    @pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-1.3b", "zamba2-1.2b"])
    def test_graph_replay_matches_per_token_eager(self, cuda, arch):
        """Batches through the pooled cache of one bucket, each decoding
        past ``max_len`` (plen + gen_len - 1 = 23 > 20): the first runs
        eagerly and captures, the others replay both graphs, and every one
        gives the eager per-token loop's tokens and launches its kernels
        as often."""
        eng = self._engine(arch, cuda)
        ref = self._engine(arch, cuda, params=eng.params, fused_decode=False)
        rng = np.random.default_rng(3)
        for i, n in enumerate((2, 2, 1, 2)):
            prompts = rng.integers(0, eng.cfg.vocab_size, (n, 16)).astype(np.int32)
            tops.reset_launches()
            got, _ = eng.generate(prompts)
            replayed = tops.launches()
            tops.reset_launches()
            want, _ = ref.generate(prompts)
            np.testing.assert_array_equal(got, want, err_msg=f"batch {i}")
            assert replayed == tops.launches() and sum(replayed.values()) > 0
        assert set(eng.graphs) == {("prefill", 1, 16), ("fused", 1, 8),
                                   ("prefill", 2, 16), ("fused", 2, 8)}
        assert eng.graph_replays == 2 * 2 and eng.compile_count == 4

    def test_capture_does_not_wait_for_another_replicas_stream(self, cuda):
        """With replica 0's stream held by a ~2 s sleep, replica 1 serves a
        key it has not seen (an eager run, then both captures) and replays
        it, well before the sleep ends and with the per-token tokens."""
        import dataclasses
        import time

        from repro_torch.serving.engine import ReplicaPool

        eng = self._engine("qwen2-0.5b", cuda, max_len=32, fused_decode=False)
        pool = ReplicaPool(eng.cfg, dataclasses.replace(eng.ecfg, fused_decode=True),
                           n_replicas=2, params=eng.params, device=cuda)
        r0, r1 = pool.replicas
        prompts = np.random.default_rng(4).integers(0, eng.cfg.vocab_size,
                                                    (2, 16)).astype(np.int32)
        want, _ = eng.generate(prompts)  # loads every kernel first
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(100_000_000)
        end.record()
        end.synchronize()
        cycles = int(2000.0 * 1e8 / start.elapsed_time(end))  # ~2 s
        with torch.cuda.stream(r0.stream):
            torch.cuda._sleep(cycles)
        t0 = time.monotonic()
        captured, _ = r1.generate(prompts)
        replayed, _ = r1.generate(prompts)
        took = time.monotonic() - t0
        held = not r0.stream.query()
        r0.stream.synchronize()
        assert held, "replica 0's sleep ended before replica 1 returned"
        assert took < 1.0, f"replica 1 took {took:.3f} s beside a 2 s sleep on replica 0"
        assert len(r1.graphs) == 2 and r1.graph_replays == 2
        np.testing.assert_array_equal(captured, want)
        np.testing.assert_array_equal(replayed, want)

    def test_refused_capture_raises(self, cuda):
        """A decode step that syncs with the host (refused under capture):
        the first batch's eager run succeeds, then the loop's capture
        raises, and so does the next batch: nothing runs the eager loop in
        its place."""
        eng = self._engine("qwen2-0.5b", cuda)
        step = eng.model.decode_step

        def syncing_step(params, tokens, cache, rope=None):
            int(cache["len"])  # a device-to-host read
            return step(params, tokens, cache, rope=rope)

        eng.model.decode_step = syncing_step
        prompts = np.ones((2, 16), np.int32)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                eng.generate(prompts)
        assert ("fused", 2, 8) not in eng.graphs and eng.graph_replays == 0


@pytest.mark.cuda
def test_full_width_seamless_launches(cuda):
    """Full-width seamless-m4t-large-v2 (bf16, 1.632 G params): a prefill
    over (2, 4096) frames and a 128-token prompt launches the flash kernel
    72 times (24 encoder, 24 causal, 24 cross), a decode step the decode
    kernel 48 times (24 self, 24 cross); the logits are finite."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    model = Model(get_config("seamless-m4t-large-v2"))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = model.init(gen)
    frames = torch.randn((2, 4096, 1024), generator=gen, device=cuda)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 128), generator=gen, device=cuda)
    cache = model.init_cache(2, 144, device=cuda)
    tops.reset_launches()
    logits, cache = model.prefill(params, {"frames": frames, "tokens": tokens}, cache)
    torch.cuda.synchronize()
    assert tops.launches() == {"flash_attention": 72, "decode_attention": 0,
                               "mlstm_attention": 0, "ssd_scan": 0}
    logits, cache = model.decode_step(params, logits.argmax(-1), cache)
    torch.cuda.synchronize()
    assert tops.launches()["decode_attention"] == 48
    assert logits.shape == (2, 1, model.cfg.vocab_size) and bool(torch.isfinite(logits).all())


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, whose training checks these
    tests run (one copy of each check)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(tops.WRAPPERS))
def test_wrappers_refuse_grad_and_train_on_plain_versions(cuda, name):
    """A kernel has no backward: given a CUDA input that requires grad, with
    grad mode on, the wrapper raises instead of returning a detached result;
    under no_grad it launches the kernel; inside ``plain_versions()`` it
    returns the plain result with a gradient and counts no launch."""
    _chip_smoke().check_training_refuses_kernels(torch, [name])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "xlstm-1.3b", "zamba2-1.2b"])
def test_reduced_loss_grads_on_the_card_match_the_cpu(cuda, arch):
    """``Model.loss`` and every gradient leaf of a reduced arch (f32, TF32
    off) on the card with ``remat=True`` against the same port on the CPU
    without, to 1e-4 of each leaf's max |g|; no kernel is launched
    (training runs the plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _chip_smoke().train_reduced(torch, arch)
