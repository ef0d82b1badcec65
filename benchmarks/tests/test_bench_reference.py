"""The plain reference against the port's CPU paths at a tiny size, and
the pieces of the check: following recorded routes, the fp8 control,
leaf norms and gaps."""

import math

import pytest
import torch

from harness import block, checks, reference
from harness.inputs import flatten, make_params
from harness.program import Port

DENSE = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
             n_experts=0, capacity_factor=1.25, lr=0.01, momentum=0.9)
MOE = dict(DENSE, n_experts=4)


def _tokens(seed, shape=(4, 16)):
    return torch.randint(0, 64, shape,
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("model", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_logits_agree_with_the_port(model):
    torch.manual_seed(0)
    params = make_params(block, model, 3, "cpu")
    tokens = _tokens(4)
    port = Port(block, model, "cpu").forward(params, tokens)
    ref = reference.logits(flatten(params), tokens, model)
    assert port.shape == ref.shape == (4, 16, 64)
    # bf16 products against f32: a few bf16 ulps of logits of size ~1
    # (MoE: route flips at near-ties move whole tokens, so the median)
    diff = (port - ref).abs()
    if model["n_experts"]:
        assert diff.median() < 0.02
    else:
        assert diff.max() < 0.05


@pytest.mark.parametrize("model", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_step_agrees_with_the_port_on_the_programs_routes(model):
    params = make_params(block, model, 5, "cpu")
    momentum = {k: torch.zeros_like(v) for k, v in flatten(params).items()}
    ref_params = {k: v.clone() for k, v in flatten(params).items()}
    ref_momentum = {k: torch.zeros_like(v) for k, v in ref_params.items()}
    tokens = _tokens(6)
    routes = reference.Routes() if model["n_experts"] else None
    loss = Port(block, model, "cpu").step(params, _nest(momentum, params),
                                          tokens, routes)
    given = None if routes is None else reference.Routes(routes.by_layer,
                                                         follow=True)
    ref_loss = reference.sgd_step(ref_params, ref_momentum, tokens, model,
                                  "f32", given)
    assert abs(loss.item() - ref_loss.item()) < 5e-3
    got, want = checks.leaf_norms(momentum), checks.leaf_norms(ref_momentum)
    assert max(checks.leaf_gaps(got, want, want).values()) < 0.01
    if given is not None:
        assert len(routes.by_layer) == model["n_layers"]
        assert given.gap < 0.01


def _nest(flat, like):
    out = {}
    for key, val in like.items():
        out[key] = (_nest({k.split(".", 1)[1]: v for k, v in flat.items()
                           if k.startswith(key + ".")}, val)
                    if isinstance(val, dict) else flat[key])
    return out


def test_routes_that_do_not_cover_the_batch_read_inf():
    routes = reference.Routes({0: torch.zeros(3, dtype=torch.long)},
                              follow=True)
    gates = torch.softmax(torch.randn(5, 4), -1)
    assert routes.pick(0, gates).shape == (5,)
    assert routes.gap == math.inf


def test_fp8_control_rounds_and_passes_gradients():
    a = torch.randn(16, 32, requires_grad=True)
    b = torch.randn(32, 8, requires_grad=True)
    exact = a @ b
    low = reference.matmul(a, b, "fp8")
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.2
    low.sum().backward()
    assert a.grad is not None and b.grad is not None
    assert torch.allclose(reference.matmul(a, b, "f32"), exact)


def test_no_tf32_restores_the_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    with reference.no_tf32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_train_numbers_by_worst_and_median_leaf():
    ref = {"losses": [3.0, 2.9, 2.8],
           "grad": {"a": 1.0, "b": 2.0, "c": 1e-6},
           "update": {"a": 1.0, "b": 2.0, "c": 5.0}}
    got = {"losses": [3.0, 2.95, 2.8],
           "grad": {"a": 1.1, "b": 2.0, "c": 0.0},
           "update": {"a": 1.0, "b": 2.2, "c": 0.0}}
    numbers = checks.train_numbers(got, ref)
    assert numbers["loss_gap"] == pytest.approx(0.05)
    # grad: floor is the median leaf's 1.0; a reads 0.1, c 1e-6 / 1
    assert numbers["grad_gap"] == pytest.approx(0.1)
    # update: c's reference gradient is under a thousandth of the median
    # leaf's, so it is left out; b reads 0.2 / 2
    assert numbers["update_gap"] == pytest.approx(0.1)
    assert "route_gap" not in numbers
    assert checks.judge(numbers, {"loss_gap": {"limit": 0.1}})
    assert not checks.judge(numbers, {"grad_gap": {"limit": 0.05}})
    assert not checks.judge(numbers, {})
    assert not checks.judge({"loss_gap": float("nan")},
                            {"loss_gap": {"limit": 1.0}})


def test_score_numbers_by_hand():
    ref = torch.tensor([[[0.0, 2.0, 1.0], [3.0, 0.0, 0.0]]])
    tokens = torch.tensor([[1, 0]])
    top, logprob = checks.answer(ref, tokens)
    assert top.tolist() == [[1, 0]]
    same = checks.score_numbers(top, logprob, ref, tokens)
    assert same == {"top1_gap": 0.0, "top1_gap_mean": 0.0,
                    "logprob_gap": 0.0, "logprob_gap_mean": 0.0}
    wrong = checks.score_numbers(torch.tensor([[2, 0]]), logprob - 0.5, ref,
                                 tokens)
    assert wrong["top1_gap"] == pytest.approx(1.0)
    assert wrong["top1_gap_mean"] == pytest.approx(0.5)
    assert wrong["logprob_gap"] == pytest.approx(0.5)
