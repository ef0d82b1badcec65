"""The traffic generator: deterministic in the seed, the same work for
every seed, and the stated length distribution."""

import json
import math
from statistics import NormalDist, median

import torch

from harness import block
from harness.inputs import make_leaf, make_params, subseed
from harness.traffic import cycle_lengths, make_plan

from tiny import BENCH

MODEL = dict(vocab=50, d_model=8, n_heads=2, d_ff=16, n_layers=2,
             n_experts=0)
SHORT = {"kind": "score", "batch": 32,
         "length": {"median": 256, "sigma": 0.6, "min": 64, "max": 512,
                    "multiple": 64},
         "cycle": 64, "sample": 16,
         "report": {"tokens_per_s": "score_tokens_per_s"}}


def _mix(name):
    return json.loads((BENCH / "mixes" / f"{name}.json").read_text())


def test_score_lengths_are_the_lognormal_quantiles():
    mix = _mix("score-8-ln1024")
    spec = mix["length"]
    lengths = cycle_lengths(spec, mix["cycle"])
    assert len(lengths) == mix["cycle"]
    assert all(spec["min"] <= n <= spec["max"] and n % spec["multiple"] == 0
               for n in lengths)
    # rounding up to the multiple moves the median up by less than one
    assert 1024 <= median(lengths) < 1024 + 64
    # the clipped share is the lognormal's tail above the maximum (and what
    # rounds up to it)
    tail = 1 - NormalDist(math.log(1024), 0.6).cdf(math.log(2048 - 64))
    assert lengths.count(2048) == round(tail * mix["cycle"])
    short = SHORT
    assert 256 <= median(cycle_lengths(short["length"], short["cycle"])) \
        < 256 + 64


def test_every_seed_gets_the_same_lengths_in_another_order():
    mix = SHORT
    k = mix["cycle"]
    a = make_plan(mix, MODEL, 1, "cpu")
    b = make_plan(mix, MODEL, 2 ** 31 + 11, "cpu")
    first_a = [a.length(i) for i in range(3 * k)]
    first_b = [b.length(i) for i in range(3 * k)]
    assert first_a != first_b
    for c in range(3):
        assert sorted(first_a[c * k:(c + 1) * k]) == a.cycle
        assert sorted(first_b[c * k:(c + 1) * k]) == a.cycle


def test_plans_are_deterministic_in_the_seed():
    for name in ("score-8-ln1024", "train-8x2048"):
        mix = dict(_mix(name), pool=2) if name.startswith("train") \
            else _mix(name)
        one = make_plan(mix, MODEL, 5, "cpu")
        two = make_plan(mix, MODEL, 5, "cpu")
        other = make_plan(mix, MODEL, 6, "cpu")
        if mix["kind"] == "train":
            assert torch.equal(one.pool, two.pool)
            assert not torch.equal(one.pool, other.pool)
            assert one.pool.shape == (2, 8, 2048)
            assert int(one.pool.max()) < MODEL["vocab"]
        else:
            assert one.sample == two.sample
            assert torch.equal(one.prompt(3), two.prompt(3))
            assert one.prompt(3).shape == (8, one.length(3))
            lengths = [one.length(i) for i in range(mix["cycle"])]
            assert lengths[max(range(len(lengths)),
                               key=lambda i: (lengths[i], -i))] == 2048
            assert max(lengths[i] for i in one.sample) == 2048
            # the shortest too: it takes the einsum branch (under 512)
            assert min(lengths[i] for i in one.sample) == min(lengths) == 256
            assert len(one.sample) == mix["sample"]


def test_weights_are_made_again_leaf_by_leaf_from_the_seed():
    params = make_params(block, MODEL, 2 ** 33 + 1, "cpu")
    again = make_leaf(block, MODEL, "layers.w1", 2 ** 33 + 1, "cpu")
    assert torch.equal(params["layers"]["w1"], again)
    assert not torch.equal(make_leaf(block, MODEL, "layers.w1", 2, "cpu"),
                           again)
    assert params["embed"].std().item() == \
        pytest_approx(MODEL["d_model"] ** -0.5)
    assert subseed(-1, "x") != subseed(1, "x")


def pytest_approx(value):
    import pytest
    return pytest.approx(value, rel=0.1)
