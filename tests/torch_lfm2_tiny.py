"""The hybrid block at a tiny LFM2 shape, and its plain reference.

The reference is the benchmark's definition of LFM2-8B-A1B
(`benchmarks/definitions/lfm2-8b-a1b.py`: plain float32 PyTorch, nothing
of the port), loaded by path; its `harness` helpers come from
`benchmarks/`. Shared by tests/test_torch_lfm2.py (CPU) and
tests/test_torch_gpu.py (the card); imports no JAX. pytest does not
collect it.

Tolerances, each a relative error (||port - ref|| / ||ref||, per leaf for
gradients and updates), the port in bf16 against the reference in f32 on
the same weights, the reference following the port's routes. Each
component alone (conv, attention, SwiGLU, MoE, forward and backward) is
within 1% of the reference: bf16 rounds inputs, weights and outputs at
2^-9 each. Through the whole tiny model these add up: over four seeds the
port's loss reads within 4e-3 of the reference's, its logits within 4%
(by max |d| over max |ref|), every leaf's gradient within 5.2%; the same
reference with fp8 products (the control) reads 20-32% on the logits and
38% or more on every leaf's gradient, so it fails both bounds below.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
DEFINITION_PATH = ROOT / "benchmarks" / "definitions" / "lfm2-8b-a1b.py"

LOSS_TOL = 0.01       # port 4e-3 at most over 4 seeds
LOGITS_TOL = 0.1      # port 4%, control 20% or more
GRAD_TOL = 0.15       # port 5.2% at most on any leaf, control 38% or more

# d 64, 4 query heads over 2 key-value heads of 16, 3 conv and 1
# attention layers, 1 dense layer before 3 MoE layers, top-2 of 8 experts
MODEL = dict(vocab=64, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
             n_layers=4, layer_types=["conv", "conv", "attention", "conv"],
             n_dense_layers=1, n_experts=8, experts_held=4, expert_d_ff=32,
             experts_per_token=2, rope_theta=1e6, norm_eps=1e-5, lr=0.01,
             momentum=0.9)
BATCH, SEQ = 2, 32


# the definition and these helpers take `harness` from benchmarks/
if str(ROOT / "benchmarks") not in sys.path:
    sys.path.insert(0, str(ROOT / "benchmarks"))


def definition():
    """The definition module, loaded by path as the benchmark loads it."""
    from harness.spec import load_definition
    return load_definition(DEFINITION_PATH)


def inputs(seed: int, device, model=MODEL):
    """(flat f32 params, tokens (BATCH, SEQ)) on `device`, the params drawn
    as the benchmark draws them."""
    from harness.inputs import flatten, make_params
    params = flatten(make_params(definition(), model, seed, device))
    tokens = torch.randint(0, model["vocab"], (BATCH, SEQ),
                           generator=torch.Generator().manual_seed(seed))
    return params, tokens.to(device)


def rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).norm()
            / ref.float().norm().clamp(min=1e-30)).item()


def max_rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


def port_step(workload, params, tokens, attention: str):
    """One port `sgd_step` on copies of `params`, recording its routes:
    (loss, gradient and updated params as flat dicts, routes)."""
    from harness.inputs import flatten, nest
    d = definition()
    cfg = workload.ModelConfig(**MODEL, batch=BATCH, seq_len=SEQ)
    p = nest({k: v.clone() for k, v in params.items()})
    m = nest({k: torch.zeros_like(v) for k, v in params.items()})
    routes = d.new_routes(MODEL)
    with d.record(workload, routes):
        _, _, loss = workload.sgd_step(p, m, tokens, cfg, attention)
    return loss.item(), flatten(m), flatten(p), routes


def reference_step(params, tokens, routes, precision: str = "f32"):
    """The definition's step on copies of `params`, following `routes`:
    (loss, gradient, updated params, the routes' gap)."""
    d = definition()
    p = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    given = d.new_routes(MODEL, routes.by_layer, follow=True)
    loss = d.sgd_step(p, m, tokens, MODEL, precision, given)
    return loss.item(), m, p, given.gap


def step_gaps(got, ref, params) -> dict:
    """Loss gap, and each leaf's worst gradient and update gap, of two
    steps' results (port_step's or reference_step's first three)."""
    loss, grad, new = got
    ref_loss, ref_grad, ref_new = ref
    leaves = [k for k in ref_grad if k != "layers.moe_bias"]
    return {"loss": abs(loss - ref_loss),
            "grad": max(rel(grad[k], ref_grad[k]) for k in leaves),
            "update": max(rel(new[k] - params[k], ref_new[k] - params[k])
                          for k in leaves)}
