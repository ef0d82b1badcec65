"""The plain reference: the port's transformer block in float32 PyTorch.

Written from the model's equations, not from the port, and importing
nothing of it: token embedding, then per layer RMSNorm (eps 1e-6, no
gain), causal multi-head attention (scale head_dim ** -0.5) and a
tanh-GELU MLP, or a top-1 switch MoE (argmax of the router's softmax, the
gate scaling the expert's output, a token past its expert's capacity in
token order dropped), each on a residual; a final RMSNorm, the
unembedding, and the mean next-token cross-entropy. Training is SGD with
momentum: m <- beta m + g, p <- p - lr m.

Every matmul goes through `matmul`, which at `precision="f32"` is a plain
float32 product with TF32 off and at `"fp8"` rounds its operands to fp8
(e4m3 forward, e5m2 for gradients, one scale per tensor) first: the
control, the reference a step below the port's bf16 products.

Training a MoE, the reference can follow routes that it is given (the
program's, recorded in its step) in place of its own argmax: the port
routes on bf16 activations, so near-ties fall the other way on a few
tokens, and a whole token's expert is then different. Following the
program's routes, the comparison judges everything but the routing, and
`Routes.gap` judges the routing by itself: every expert followed must be
a near-tie of the reference's first choice.

Memory: a training step keeps each layer's input only and computes the
layer again in the backward (checkpointing), and takes the head and loss
over blocks of rows, so a Pythia-1.4B step at 8 x 2048 fits on one card
beside its f32 state.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

HEAD_ROWS = 2048          # rows of the head and loss taken at once

_FP8 = {"fwd": torch.float8_e4m3fn, "grad": torch.float8_e5m2}


def _fp8(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x rounded to fp8 with one scale for the tensor, back in f32."""
    dtype = _FP8[kind]
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _fp8(a, "fwd") @ _fp8(b, "fwd")

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = _fp8(grad, "grad")
        return (g @ _fp8(b, "fwd").transpose(-1, -2),
                _fp8(a, "fwd").transpose(-1, -2) @ g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def capacity(tokens: int, n_experts: int, factor: float) -> int:
    """Per-expert capacity: ceil(tokens x factor / experts), rounded up to
    a multiple of 8, at least 8, at most `tokens`."""
    return min(tokens, max(8, math.ceil(
        math.ceil(tokens * factor / n_experts) / 8) * 8))


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-6)


def _attention(h, wq, wk, wv, wo, model, precision):
    b, s, d = h.shape
    heads = model["n_heads"]
    dh = d // heads
    flat = h.reshape(b * s, d)

    def split(w):
        return matmul(flat, w, precision).view(b, s, heads, dh).transpose(1, 2)

    q, k, v = split(wq), split(wk), split(wv)
    scores = matmul(q, k.transpose(-1, -2), precision) * dh ** -0.5
    future = torch.ones(s, s, dtype=torch.bool, device=h.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    o = matmul(probs, v, precision).transpose(1, 2).reshape(b * s, d)
    return matmul(o, wo, precision).view(b, s, d)


class Routes:
    """Top-1 routes by layer, for one step or forward: recorded where
    `follow` is False (each layer's argmax), or followed, as given, where
    it is True. Following, `gap` is the widest margin by which the
    reference's own router probability of its first choice exceeds that
    of the expert followed: near 0 where the two differ only at ties."""

    def __init__(self, by_layer=None, follow: bool = False):
        self.by_layer = dict(by_layer or {})
        self.follow = follow
        self.gap = 0.0

    def pick(self, layer: int, gates: torch.Tensor) -> torch.Tensor:
        own = gates.argmax(-1)
        if not self.follow:
            self.by_layer.setdefault(layer, own)
            return self.by_layer[layer]
        given = self.by_layer.get(layer)
        if given is None or given.shape != own.shape:
            self.gap = math.inf          # routes that do not cover the batch
            return own
        with torch.no_grad():
            margin = (gates.gather(1, own[:, None])
                      - gates.gather(1, given[:, None].long())).max().item()
        self.gap = max(self.gap, margin)
        return given.long()


def _moe(h, wr, w1e, w2e, model, precision, layer, routes):
    b, s, d = h.shape
    t, experts = b * s, model["n_experts"]
    flat = h.reshape(t, d)
    gates = torch.softmax(matmul(flat, wr, precision), -1)
    top1 = (gates.argmax(-1) if routes is None
            else routes.pick(layer, gates.detach()))
    gate = gates.gather(1, top1[:, None])[:, 0]
    onehot = F.one_hot(top1, experts)
    place = onehot.cumsum(0).gather(1, top1[:, None])[:, 0]
    kept = place <= capacity(t, experts, model["capacity_factor"])
    out = flat.new_zeros(t, d)
    for e, (w1, w2) in enumerate(zip(w1e.unbind(0), w2e.unbind(0))):
        rows = torch.nonzero(kept & (top1 == e)).flatten()
        if rows.numel():
            hidden = F.gelu(matmul(flat[rows], w1, precision),
                            approximate="tanh")
            y = matmul(hidden, w2, precision) * gate[rows, None]
            out = out.index_put((rows,), y)
    return out.view(b, s, d)


def _mlp(h, w1, w2, model, precision):
    b, s, d = h.shape
    hidden = F.gelu(matmul(h.reshape(b * s, d), w1, precision),
                    approximate="tanh")
    return matmul(hidden, w2, precision).view(b, s, d)


def _block(x, *weights, model, precision, layer, routes):
    wq, wk, wv, wo, *ffn = weights
    x = x + _attention(_rms(x), wq, wk, wv, wo, model, precision)
    if model.get("n_experts", 0):
        return x + _moe(_rms(x), *ffn, model, precision, layer, routes)
    return x + _mlp(_rms(x), *ffn, model, precision)


def _layer_keys(model: dict) -> List[str]:
    ffn = ["wr", "w1e", "w2e"] if model.get("n_experts", 0) else ["w1", "w2"]
    return ["layers." + k for k in ["wq", "wk", "wv", "wo", *ffn]]


def _trunk(params: Dict[str, torch.Tensor], tokens, model, precision,
           remat: bool, routes) -> torch.Tensor:
    """The final RMSNorm's output (b, s, d) in f32."""
    x = params["embed"][tokens]
    for layer, weights in enumerate(zip(*(params[k].unbind(0)
                                          for k in _layer_keys(model)))):
        block = partial(_block, model=model, precision=precision,
                        layer=layer, routes=routes)
        if remat:
            x = checkpoint(block, x, *weights, use_reentrant=False)
        else:
            x = block(x, *weights)
    return _rms(x)


def _nll_sum(h, unembed, targets, precision):
    logits = matmul(h, unembed, precision)
    return -torch.log_softmax(logits, -1).gather(1, targets[:, None]).sum()


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor, model: dict,
         precision: str = "f32", routes: Optional[Routes] = None
         ) -> torch.Tensor:
    """Mean next-token cross-entropy over tokens (b, s): position i of each
    row predicts token i + 1. `routes`: the MoE's, recorded or followed."""
    b, s = tokens.shape
    h = _trunk(params, tokens, model, precision, True, routes)
    h = h[:, :-1].reshape(-1, h.shape[-1])
    targets = tokens[:, 1:].reshape(-1)
    total = h.new_zeros(())
    nll = partial(_nll_sum, precision=precision)
    for start in range(0, h.shape[0], HEAD_ROWS):
        rows = slice(start, start + HEAD_ROWS)
        total = total + checkpoint(nll, h[rows], params["unembed"],
                                   targets[rows], use_reentrant=False)
    return total / (b * (s - 1))


def sgd_step(params: Dict[str, torch.Tensor], momentum: Dict[str, torch.Tensor],
             tokens: torch.Tensor, model: dict, precision: str = "f32",
             routes: Optional[Routes] = None) -> torch.Tensor:
    """One training step on flat {name: leaf} dicts, updated in place;
    returns the loss before the update."""
    names = sorted(params)
    leaves = [params[n].detach().requires_grad_() for n in names]
    with no_tf32(), torch.enable_grad():
        value = loss(dict(zip(names, leaves)), tokens, model, precision,
                     routes)
        grads = torch.autograd.grad(value, leaves)
    with torch.no_grad():
        for name, g in zip(names, grads):
            momentum[name].mul_(model["momentum"]).add_(g)
            params[name].sub_(momentum[name], alpha=model["lr"])
    return value.detach()


@torch.no_grad()
def logits(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
           model: dict, precision: str = "f32") -> torch.Tensor:
    """Logits (b, s, vocab) in f32."""
    with no_tf32():
        h = _trunk(params, tokens, model, precision, False, None)
        return matmul(h, params["unembed"], precision)
