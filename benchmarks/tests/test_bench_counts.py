"""The FLOP and byte counts against hand-worked counts."""

import json

import pytest

from harness import counts
from harness.peaks import Peak

from tiny import BENCH


def _model(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["model"]


def test_capacity_is_the_switch_rule():
    assert counts.capacity(65536, 8, 1.25) == 10240   # switch-base-8 train
    assert counts.capacity(100, 4, 1.25) == 32        # ceil(31.25) = 32
    assert counts.capacity(16, 4, 1.25) == 8          # at least 8
    assert counts.capacity(6, 4, 1.25) == 6           # at most the tokens


def test_model_flops_by_hand_at_a_small_shape():
    m = dict(vocab=10, d_model=4, n_heads=2, d_ff=8, n_layers=1, n_experts=0)
    # per token: q,k,v,o 4 x 2*4*4 = 128; MLP 2 x 2*4*8 = 128 -> 256 x 2
    # tokens = 512; causal attention 4 * d * pairs = 4 * 4 * 3 = 48; head
    # 2 * 4 * 10 * 2 = 160
    assert counts.model_flops(m, 1, 2, train=False) == 720
    assert counts.model_flops(m, 1, 2, train=True) == 2160
    moe = dict(m, n_experts=3)          # + router 2 * 4 * 3 per token
    assert counts.model_flops(moe, 1, 2, train=False) == 720 + 2 * 24


def test_model_flops_at_the_published_widths():
    tokens, pairs = 8 * 2048, 2048 * 2049 // 2
    per_token = 8 * 2048 ** 2 + 4 * 2048 * 8192
    layer = tokens * per_token + 4 * 2048 * 8 * pairs
    forward = 24 * layer + 2 * 2048 * 50304 * tokens
    assert counts.model_flops(_model("pythia-1.4b"), 8, 2048, True) == \
        3 * forward
    assert 3 * forward == pytest.approx(1.388e14, rel=1e-3)
    tokens, pairs = 128 * 512, 512 * 513 // 2
    per_token = 8 * 768 ** 2 + 4 * 768 * 3072 + 2 * 768 * 8
    layer = tokens * per_token + 4 * 768 * 128 * pairs
    forward = 12 * layer + 2 * 768 * 32128 * tokens
    assert counts.model_flops(_model("switch-base-8"), 128, 512, True) == \
        3 * forward


def test_gemm_work_by_hand():
    m = dict(vocab=10, d_model=4, n_heads=2, d_ff=8, n_layers=1, n_experts=0)
    work = counts.gemm_work(m, 1, 2, "flash", train=False)
    # q, k, v, o: (2, 4) @ (4, 4); w1 (2, 4) @ (4, 8); w2 (2, 8) @ (8, 4);
    # head (2, 4) @ (4, 10); bf16: 2 bytes per element read or written
    assert work == [(64.0, 2.0 * (8 + 16 + 8), "bf16")] * 4 + [
        (128.0, 2.0 * (8 + 32 + 16), "bf16"),
        (128.0, 2.0 * (16 + 32 + 8), "bf16"),
        (160.0, 2.0 * (8 + 40 + 20), "bf16")]
    train = counts.gemm_work(m, 1, 2, "flash", train=True)
    assert len(train) == 3 * len(work)
    assert sum(f for f, _, _ in train) == 3 * sum(f for f, _, _ in work)
    # einsum attention adds QK^T and PV for each of the 2 heads: (2, 2) @
    # (2, 2) each, 2 * 2 * 2 * 2 FLOPs
    einsum = counts.gemm_work(m, 1, 2, "einsum", train=False)
    assert sum(f for f, _, _ in einsum) - sum(f for f, _, _ in work) == \
        2 * 2 * (2 * 2 * 2 * 2)


def test_moe_gemm_work_runs_over_the_capacity_buffer():
    m = dict(vocab=10, d_model=4, n_heads=2, d_ff=8, n_layers=1, n_experts=2,
             capacity_factor=1.25)
    work = counts.gemm_work(m, 1, 16, "flash", train=False)
    slots = counts.capacity(16, 2, 1.25)              # 10 -> 16 (mult. of 8)
    assert slots == 16
    assert (2.0 * 16 * 4 * 2, 4.0 * (64 + 8 + 32), "f32") in work    # router
    assert (2.0 * 2 * slots * 4 * 8,
            2.0 * 2 * (slots * 4 + 4 * 8 + slots * 8), "bf16") in work


def test_attention_work_and_bounds():
    m = dict(d_model=256, n_heads=2, n_layers=3)
    fwd, bwd = counts.attention_work(m, 2, 128, train=True)[:2]
    hb, dh, pairs = 4, 128, 128 * 129 // 2
    assert fwd[0] == 4 * hb * dh * pairs
    assert bwd[0] == 8 * hb * dh * pairs
    assert fwd[1] == 2 * 4 * hb * 128 * dh + 4 * hb * 128
    assert bwd[1] == 2 * 8 * hb * 128 * dh + 4 * hb * 128
    assert len(counts.attention_work(m, 2, 128, train=False)) == 3
    peak = Peak(bf16_flops=1e12, f32_flops=1e11, hbm_bytes=1e9)
    # each piece takes the larger of its two times
    assert counts.bound_s([(2e12, 1e9, "bf16"), (1e10, 5e9, "f32")],
                          peak) == pytest.approx(2.0 + 5.0)
