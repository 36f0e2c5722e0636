"""The hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU (the kernels have no CPU mode) and skip without
one. Run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``.
The file imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_TOL = {k: 2 * v for k, v in TOL.items()}  # the signed denominator amplifies rounding


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(getattr(torch, dtype))
            for s in shapes]


def _close(got, want, dtype, tol=TOL):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               atol=tol[dtype], rtol=tol[dtype])


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

    @pytest.mark.parametrize("b,s,hq,hkv,d,dtype", [
        (32, 144, 14, 2, 64, "bfloat16"),
        (4, 640, 4, 4, 32, "float32"),
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
