"""The frozen operation and byte counts against hand counts."""
import types

import pytest

from perfbench.lib import roofline, trace


def test_flash_counts():
    # q and out 2*4*4*8 = 256 elements each, k and v 2*4*2*8 = 128 each, bf16;
    # 10 causal (query, key) pairs a head, 4*d flops a pair, 8 heads
    assert roofline.flash_cost(2, 4, 4, 2, 8) == (1536, 2560)


def test_decode_counts():
    # q and out 64 elements each, 5 rows of K and V of 2*2*8 each, bf16, + the int32 length
    assert roofline.decode_cost(2, 5, 4, 2, 8) == (900, 1280)


def test_request_flops_of_a_small_gated_model():
    model = {"family": "dense", "num_layers": 2, "d_model": 4, "num_heads": 2,
             "num_kv_heads": 2, "head_dim": 2, "d_ff": 4, "vocab_size": 6,
             "activation": "silu"}
    # a token a layer: q, k, v 2*4*2*6 = 96, wo 2*4*4 = 32, gated ffn
    # 2*4*4*3 = 96; 2 tokens (1 prompt + 2 generated but the last), 3
    # (query, key) pairs at 4*2*2 flops in each of 2 layers, the head
    # 2*4*6 for each of 2 generated tokens
    assert roofline.request_flops(model, 1, 2) == 2 * 2 * 224 + 96 + 96


def test_counts_refuse_another_family():
    with pytest.raises(ValueError):
        roofline.request_flops({"family": "hybrid", "num_layers": 1, "d_model": 4,
                                "num_heads": 2, "num_kv_heads": 2, "d_ff": 4,
                                "vocab_size": 6}, 1, 1)


def test_request_flops_of_a_small_dense_model():
    model = {"family": "dense", "num_layers": 1, "d_model": 4, "num_heads": 2,
             "num_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
             "activation": "gelu"}
    # a token: q, k, v 2*4*2*4 = 64, wo 2*4*4 = 32, ffn 2*2*4*8 = 128;
    # 4 tokens (3 prompt + 1 generated but the last), 10 (query, key) pairs
    # at 4*2*2 flops, the head 2*4*10 for each of 2 generated tokens
    assert roofline.request_flops(model, 3, 2) == 4 * 224 + 160 + 160


def test_bound_and_union():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 989e12) == pytest.approx(1.0)
    assert roofline.union_length([(0, 2), (1, 3), (5, 6)]) == 4


def test_port_kernel_names():
    name = "void (anonymous namespace)::flash_mma_kernel<64, 64, 128>(Params)"
    assert roofline.port_kernel(name) == "flash_attention"
    assert roofline.port_kernel("void (anonymous namespace)::ssd_mma_kernel<8>(P)") == "ssd_scan"
    assert roofline.port_kernel("ampere_bf16_s16816gemm_bf16_128x128") is None


def _record(decode_launches_seen: int):
    """A traced slice of one (bucket 2, prompt 4) batch of 3 tokens of a
    one-layer model: one flash launch, two decode launches."""
    model = {"family": "dense", "num_layers": 1, "d_model": 8, "num_heads": 2,
             "num_kv_heads": 1, "head_dim": 4}
    flash = "void (anonymous namespace)::flash_mma_kernel<64>(Params)"
    decode = "void (anonymous namespace)::decode_split_kernel<4>(Params)"
    events = [(flash, True, 0.0, 10.0)] + [
        (decode, True, 20.0 + 10 * i, 25.0 + 10 * i) for i in range(decode_launches_seen)]
    profile = types.SimpleNamespace(events=events, window_s=1e-4,
                                    batches=[types.SimpleNamespace(bucket=2, plen=4)])
    return types.SimpleNamespace(model=model, mix={"gen_len": 3}, profile=profile)


@pytest.mark.parametrize("seen, read", [(2, True), (1, False), (0, False)])
def test_a_roofline_share_needs_every_launch_of_its_batches(seen, read):
    """Where the profiler dropped some of a kernel's launches, no share is read."""
    share = trace.roofline_share(_record(seen), "decode_attention")
    if read:
        bound = sum(roofline.bound_s(*roofline.decode_cost(2, n, 2, 1, 4)) for n in (5, 6))
        assert share == pytest.approx(100.0 * bound / 10e-6)
    else:
        assert share is None
    assert trace.roofline_share(_record(seen), "flash_attention") == pytest.approx(
        100.0 * roofline.bound_s(*roofline.flash_cost(2, 4, 2, 1, 4)) / 10e-6)
