"""The yardstick's operation and byte counts against hand counts."""

import pytest

from benchmark.harness import counts


def test_bound_takes_the_slower_side():
    assert counts.bound(2e12, 0.0, 1e12) == (2.0, "operations")
    assert counts.bound(0.0, 3.35e12, 1e12) == (1.0, "bytes")


@pytest.mark.parametrize("backward", [False, True])
def test_attention_work_by_hand(backward):
    b, sq, sk, h, d = 2, 3, 5, 4, 8
    flops, nbytes = counts.attn_work(b, sq, sk, h, d, masked=True, colsum=True,
                                     backward=backward, elem=2)
    products = 5 if backward else 2            # QK^T, PV (+ S again, dV, dP, dQ, dK)
    assert flops == 2 * products * b * h * sq * sk * d
    q = b * sq * h * d * 2
    k = b * sk * h * d * 2
    tensors = 3 * q + 4 * k if backward else 2 * q + 2 * k   # q,dO,dQ + k,v,dK,dV | q,ctx + k,v
    assert nbytes == tensors + 4 * b * sq * sk + 4 * b * sk


def test_causal_pairs_count_only_what_the_mask_lets_through():
    s = 6
    pairs = s * (s + 1) // 2
    full, _ = counts.attn_work(1, s, s, 1, 4, masked=True, colsum=False, backward=False, elem=4)
    causal, _ = counts.attn_work(1, s, s, 1, 4, masked=True, colsum=False, backward=False,
                                 elem=4, pairs=pairs)
    assert causal * s * s == full * pairs


def test_attention_bound_uses_the_peak_of_the_type():
    call = {"b": 1, "sq": 2048, "sk": 2048, "heads": 16, "d": 128, "masked": False,
            "colsum": False}
    bf16 = counts.attention_bound_s([{**call, "elem": 2}], backward=False)
    fp32 = counts.attention_bound_s([{**call, "elem": 4}], backward=False)
    assert bf16 == pytest.approx(2 * 2 * 16 * 2048 * 2048 * 128 / counts.PEAK_BF16_FLOPS)
    assert fp32 == pytest.approx(2 * 2 * 16 * 2048 * 2048 * 128 / counts.PEAK_FP32_FLOPS)


def test_encoder_by_hand():
    rows, seq, h, i, layers = 2, 3, 8, 16, 2
    per_token = 2 * (4 * h * h + 2 * h * i)
    want = layers * (rows * seq * per_token + 4 * rows * seq * seq * h)
    assert counts.encoder_flops(rows, seq, h, i, layers) == want


def test_resnet_by_hand():
    # one group of one block at 8x8: stem 3x3 convs at 4x4, pool to 2x2, then
    # the projecting block's 1x1 proj, 1x1, 3x3 and 1x1 at 2x2
    w = 8
    stem = 2 * 16 * (3 * 4 * 9 + 4 * 4 * 9 + 4 * 8 * 9)
    block = 2 * 4 * (8 * 32 + 8 * 8 + 8 * 8 * 9 + 8 * 32)
    assert counts.resnet_flops(1, 8, 8, [1], width=w) == stem + block


def test_grover_forward_by_hand():
    m = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 1, "vocab_size": 10}
    b, s = 2, 4
    dense = b * s * 2 * (4 * 8 * 8 + 2 * 8 * 16)
    attn = 4 * b * (s * (s + 1) / 2) * 8
    head = 2 * b * s * 8 * 10
    assert counts.grover_forward_flops(m, b, s) == dense + attn + head


def test_merlot_pretrain_count_covers_each_part():
    from benchmark.harness import registry
    m = {**registry.config("merlot-base")["model"], "image_size": [192, 352]}
    f = counts.merlot_forward_flops(m, examples=8, chunks=16, tokens=32, image_size=[192, 352],
                                    group=4, pretrain=True)
    vit = counts.vision_flops(m, 128, [192, 352])
    assert vit < f < 1.6 * vit
    # ~77 GFLOP a segment forward at the cell's shapes
    assert 60e9 < f / 128 < 95e9
