"""LFM2-8B-A1B's block as a benchmark definition (harness/block.py says
what a definition holds): its leaves, its plain float32 reference, how its
routes are recorded from the port and followed, and its counts.

The block, from the published config and the LFM2 family's modelling
code: the token embedding; per layer `x += mixer(RMSNorm(x))` and
`x += mlp(RMSNorm(x))`, every RMSNorm with a weight (eps `norm_eps`);
then a final RMSNorm and the head, tied to the embedding (logits =
h @ embed^T).

- Mixer, by `layer_types`: "conv", LFM2's gated short convolution,
  `B, C, h = chunk(x @ conv_in, 3)`, `out = (C * conv(B * h)) @ conv_out`,
  the convolution depthwise and causal over TAPS taps
  (torch's conv1d with padding taps - 1, its first s outputs, as the
  published code runs it); or "full_attention": grouped-query attention,
  `n_heads` query heads over `n_kv_heads` key-value heads of d/n_heads,
  an RMSNorm over each query and key head, then RoPE (`rope_theta`,
  non-interleaved halves), causal, scale head_dim ** -0.5.
- MLP: SwiGLU, `w2(silu(w1 x) * w3 x)`, width `d_ff` in the first
  `n_dense_layers`; after them a dropless MoE over `n_experts`: scores
  s = sigmoid(x @ wr), the `experts_per_token` largest s + moe_bias chosen
  (the bias selects only), their weights the chosen s over their sum
  + 1e-6 (norm_topk_prob; routed_scaling_factor is 1); each chosen
  expert a SwiGLU of width
  `expert_d_ff`. This chip holds experts 0 .. experts_held - 1 of each
  layer (the configuration's `deployment`): the reference, like the port,
  computes only their part of each token's sum.
- Norm weights are leaves of offsets, w = 1 + g.

Leaves and their names are the port's (`layers.` stacked by kind, dim 0
the layer of that kind). The reference is plain PyTorch, importing
nothing of the port and no JAX: float32 with TF32 off at
precision="f32", and its matmuls in fp8 (harness/reference.py's `matmul`)
at "fp8", the control. A training step takes its loss and gradient a
sequence at a time (dropless routing makes each token's result its own,
so this is exact), each layer computed again in the backward, and the
attention one key-value group at a time, so that the f32 pass fits on
one card. Training follows the routes the port took (`record`); `Routes.gap`
is the widest margin by which the reference's own s + bias ranks an expert
it would have chosen above a followed one.

Counts (`model_flops`, `gemm_work`, `attention_work`, as counts.py's):
matmuls only; the experts held at the rows they expect, t k held /
n_experts; attention over the n_heads expanded heads, causal pairs once.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from harness import counts
from harness.reference import HEAD_ROWS, matmul, no_tf32

# the N(0, 1) draw's factor for the leaves that are not d x d-like
# matrices (those take d_model ** -0.5): norm offsets (w = 1 + g); the
# selection bias, small enough that the experts held take 0.245-0.255 of
# the pairs over seeds (at 0.05 they took 0.239-0.274, so a step's work
# hung on the seed) and large enough to move near-ties; the convolution's
# taps (TAPS ** -0.5: unit gain)
NORM_OFFSET_SCALE = 0.1
BIAS_SCALE = 0.005
TAPS = 3                       # conv_L_cache
NORMS = ("q_norm", "k_norm", "op_norm", "ffn_norm", "final_norm")


def _kinds(model: dict) -> List[Tuple[str, str]]:
    return [("conv" if kind == "conv" else "attention",
             "dense" if i < model["n_dense_layers"] else "moe")
            for i, kind in enumerate(model["layer_types"])]


def _dims(model: dict):
    d, h = model["d_model"], model["n_heads"]
    return d, h, model["n_kv_heads"], d // h


def leaf_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    d, h, kv, dh = _dims(model)
    ff, fe = model["d_ff"], model["expert_d_ff"]
    e, held = model["n_experts"], model["experts_held"]
    kinds = _kinds(model)
    n = {k: sum(k in pair for pair in kinds)
         for k in ("attention", "conv", "dense", "moe")}
    groups = {
        "attention": {"wq": (d, h * dh), "wk": (d, kv * dh),
                      "wv": (d, kv * dh), "wo": (h * dh, d),
                      "q_norm": (dh,), "k_norm": (dh,)},
        "conv": {"conv_in": (d, 3 * d),
                 "conv_w": (TAPS, d), "conv_out": (d, d)},
        "moe": {"wr": (d, e), "w1e": (held, d, fe), "w3e": (held, d, fe),
                "w2e": (held, fe, d), "moe_bias": (e,)},
        "dense": {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)},
    }
    shapes = {"embed": (model["vocab"], d)}
    for kind, leaves in groups.items():
        shapes.update({f"layers.{k}": (n[kind], *s)
                       for k, s in leaves.items()})
    shapes.update({"layers.op_norm": (len(kinds), d),
                   "layers.ffn_norm": (len(kinds), d), "final_norm": (d,)})
    return shapes


def leaf_scale(model: dict, name: str) -> float:
    key = name.rsplit(".", 1)[-1]
    if key in NORMS:
        return NORM_OFFSET_SCALE
    if key == "moe_bias":
        return BIAS_SCALE
    if key == "conv_w":
        return TAPS ** -0.5
    return model["d_model"] ** -0.5


# ---- routes -------------------------------------------------------------

class Routes:
    """The top-k experts (t, k) of each MoE layer (by its index among the
    MoE layers) over a step's whole batch: recorded (the reference's own,
    block by block of rows) where `follow` is False, followed where True."""

    def __init__(self, by_layer=None, follow: bool = False):
        self.by_layer = dict(by_layer or {})
        self.follow = follow
        self.gap = 0.0
        self._own: Dict[int, Dict[int, torch.Tensor]] = {}

    def pick(self, layer: int, rows: slice, sel: torch.Tensor,
             k: int) -> torch.Tensor:
        """The experts of the batch's `rows`, from the reference's own
        selection scores `sel` (s + bias) of those rows."""
        top = sel.topk(k, -1)
        if not self.follow:
            blocks = self._own.setdefault(layer, {})
            blocks.setdefault(rows.start, top.indices)
            self.by_layer[layer] = torch.cat([blocks[r]
                                              for r in sorted(blocks)])
            return blocks[rows.start]
        given = self.by_layer.get(layer)
        if (given is None or given.shape[0] < rows.stop
                or given.shape[1] != k):
            self.gap = math.inf          # routes that do not cover the batch
            return top.indices
        given = given[rows].long()
        with torch.no_grad():
            margin = (top.values[:, -1]
                      - sel.gather(1, given).min(-1).values).max().item()
        self.gap = max(self.gap, margin)
        return given


def new_routes(model: dict, by_layer=None, follow: bool = False) -> Routes:
    return Routes(by_layer, follow)


@contextlib.contextmanager
def record(workload, routes: Optional[Routes]):
    """Records the experts the port's `workload._route_topk` chooses, per
    MoE layer in order, into `routes` while open (not the recomputations
    inside a backward)."""
    if routes is None:
        yield
        return
    original, taken = workload._route_topk, []

    def recording(xt, wr, bias, cfg):
        weights, chosen = original(xt, wr, bias, cfg)
        if torch._C._current_graph_task_id() == -1:
            taken.append(chosen)
        return weights, chosen

    workload._route_topk = recording
    try:
        yield
    finally:
        workload._route_topk = original
    routes.by_layer.update(enumerate(taken))


# ---- the reference ------------------------------------------------------

def _rms(x, offset, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1 + offset)


def _conv(h, conv_in, conv_w, conv_out, model, precision):
    b, s, d = h.shape
    bch = matmul(h.reshape(b * s, d), conv_in, precision).view(b, s, 3 * d)
    gate_b, gate_c, u = bch.chunk(3, -1)
    taps = conv_w.shape[0]
    mixed = F.conv1d((gate_b * u).transpose(1, 2), conv_w.t()[:, None],
                     padding=taps - 1, groups=d)[..., :s].transpose(1, 2)
    return matmul((gate_c * mixed).reshape(b * s, d), conv_out,
                  precision).view(b, s, d)


def _rope(x, theta):
    """x (b, heads, s, dh) turned by RoPE, non-interleaved halves."""
    s, dh = x.shape[-2:]
    inv = theta ** -(torch.arange(0, dh, 2, device=x.device,
                                  dtype=torch.float32) / dh)
    angle = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    angle = torch.cat([angle, angle], -1)
    x1, x2 = x.chunk(2, -1)
    return x * angle.cos() + torch.cat([-x2, x1], -1) * angle.sin()


def _group(q, k, v, precision):
    """Causal attention of q (b, r, s, dh) over one key-value head k, v
    (b, 1, s, dh)."""
    s, dh = q.shape[-2:]
    k, v = k.expand_as(q), v.expand_as(q)
    scores = matmul(q, k.transpose(-1, -2), precision) * dh ** -0.5
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    return matmul(probs, v, precision)


def _attention(h, wq, wk, wv, wo, q_norm, k_norm, model, precision):
    b, s, d = h.shape
    _, heads, kv, dh = _dims(model)
    flat = h.reshape(b * s, d)

    def proj(w, n):
        return matmul(flat, w, precision).view(b, s, n, dh)

    q = _rope(_rms(proj(wq, heads), q_norm, model["norm_eps"]).transpose(1, 2),
              model["rope_theta"])
    k = _rope(_rms(proj(wk, kv), k_norm, model["norm_eps"]).transpose(1, 2),
              model["rope_theta"])
    v = proj(wv, kv).transpose(1, 2)
    r = heads // kv
    o = torch.cat([checkpoint(partial(_group, precision=precision),
                              q[:, g * r:(g + 1) * r], k[:, g:g + 1],
                              v[:, g:g + 1], use_reentrant=False)
                   for g in range(kv)], 1)
    return matmul(o.transpose(1, 2).reshape(b * s, d), wo,
                  precision).view(b, s, d)


def _swiglu(x, w1, w3, w2, precision):
    return matmul(F.silu(matmul(x, w1, precision)) * matmul(x, w3, precision),
                  w2, precision)


def _moe(h, wr, w1e, w3e, w2e, moe_bias, model, precision, layer=0,
         routes=None, rows=None, first=0):
    """The MoE layer's output over the experts held (w1e's first dim, the
    experts first ..), routed over all n_experts; `routes` picks the
    experts of the batch's `rows` (recorded or followed)."""
    b, s, d = h.shape
    t, k = b * s, model["experts_per_token"]
    flat = h.reshape(t, d)
    scores = torch.sigmoid(matmul(flat, wr, precision))
    sel = scores.detach() + moe_bias.detach()
    chosen = (sel.topk(k, -1).indices if routes is None
              else routes.pick(layer, rows or slice(0, t), sel, k))
    weights = scores.gather(1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + 1e-6)
    out = flat.new_zeros(t, d)
    for e in range(w1e.shape[0]):
        hit = chosen == first + e
        tokens = torch.nonzero(hit.any(-1)).flatten()
        if tokens.numel():
            y = _swiglu(flat[tokens], w1e[e], w3e[e], w2e[e], precision)
            out = out.index_add(0, tokens,
                                y * (weights * hit).sum(-1)[tokens, None])
    return out.view(b, s, d)


def _layer(x, w, kind, model, precision, layer, routes, rows):
    mixer, mlp = kind
    eps = model["norm_eps"]
    h = _rms(x, w["op_norm"], eps)
    if mixer == "conv":
        x = x + _conv(h, w["conv_in"], w["conv_w"], w["conv_out"], model,
                      precision)
    else:
        x = x + _attention(h, w["wq"], w["wk"], w["wv"], w["wo"],
                           w["q_norm"], w["k_norm"], model, precision)
    h = _rms(x, w["ffn_norm"], eps)
    if mlp == "dense":
        b, s, d = h.shape
        return x + _swiglu(h.reshape(b * s, d), w["w1"], w["w3"], w["w2"],
                           precision).view(b, s, d)
    return x + _moe(h, w["wr"], w["w1e"], w["w3e"], w["w2e"], w["moe_bias"],
                    model, precision, layer, routes, rows)


def _per_layer(params: Dict[str, torch.Tensor], model: dict):
    """Each layer's kind, its index among the MoE layers, and {leaf key:
    its slice}. Unbound once per leaf: its backward stacks the slices'
    gradients once, where each index's would add a zero gradient of the
    whole stack."""
    slices = {name.rsplit(".", 1)[-1]: leaf.unbind(0)
              for name, leaf in params.items() if name.startswith("layers.")}
    taken = {k: 0 for k in ("attention", "conv", "dense", "moe")}
    out = []
    for i, kind in enumerate(_kinds(model)):
        w = {"op_norm": slices["op_norm"][i],
             "ffn_norm": slices["ffn_norm"][i]}
        w.update({key: per[taken[_GROUP[key]]]
                  for key, per in slices.items()
                  if _GROUP.get(key) in kind})
        out.append((kind, taken["moe"], w))
        for group in kind:
            taken[group] += 1
    return out


_GROUP = {**dict.fromkeys(("wq", "wk", "wv", "wo", "q_norm", "k_norm"),
                          "attention"),
          **dict.fromkeys(("conv_in", "conv_w", "conv_out"), "conv"),
          **dict.fromkeys(("w1", "w3", "w2"), "dense"),
          **dict.fromkeys(("wr", "w1e", "w3e", "w2e", "moe_bias"), "moe")}


def _trunk(params, tokens, model, precision, remat, routes, row0=0):
    """The final RMSNorm's output (b, s, d) in f32 for tokens (b, s), rows
    row0 .. of the step's batch."""
    x = params["embed"][tokens]
    rows = slice(row0, row0 + tokens.numel())
    for kind, moe_index, w in _per_layer(params, model):
        fn = partial(_layer, kind=kind, model=model, precision=precision,
                     layer=moe_index, routes=routes, rows=rows)
        x = (checkpoint(fn, x, w, use_reentrant=False) if remat
             else fn(x, w))
    return _rms(x, params["final_norm"], model["norm_eps"])


def _nll_sum(h, embed, targets, precision):
    logits = matmul(h, embed.t(), precision)
    return -torch.log_softmax(logits, -1).gather(1, targets[:, None]).sum()


def _sequence_nll(params, tokens, model, precision, routes, row0):
    """The summed next-token NLL of one sequence (1, s)."""
    h = _trunk(params, tokens, model, precision, True, routes, row0)[0, :-1]
    targets = tokens[0, 1:]
    total = h.new_zeros(())
    nll = partial(_nll_sum, precision=precision)
    for start in range(0, h.shape[0], HEAD_ROWS):
        block = slice(start, start + HEAD_ROWS)
        total = total + checkpoint(nll, h[block], params["embed"],
                                   targets[block], use_reentrant=False)
    return total


def sgd_step(params: Dict[str, torch.Tensor],
             momentum: Dict[str, torch.Tensor], tokens: torch.Tensor,
             model: dict, precision: str = "f32",
             routes: Optional[Routes] = None) -> torch.Tensor:
    """One training step on flat {name: leaf} dicts, updated in place: the
    mean next-token cross-entropy's gradient summed a sequence at a time;
    returns the loss before the update. `moe_bias` gets no gradient."""
    names = sorted(params)
    leaves = {n: params[n].detach().requires_grad_() for n in names}
    b, s = tokens.shape
    value = torch.zeros((), device=tokens.device)
    with no_tf32(), torch.enable_grad():
        for row in range(b):
            part = _sequence_nll(leaves, tokens[row:row + 1], model,
                                 precision, routes, row * s) / (b * (s - 1))
            part.backward()
            value += part.detach()
    with torch.no_grad():
        for n in names:
            g = leaves[n].grad
            momentum[n].mul_(model["momentum"])
            if g is not None:
                momentum[n].add_(g)
            params[n].sub_(momentum[n], alpha=model["lr"])
    return value


@torch.no_grad()
def logits(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
           model: dict, precision: str = "f32",
           routes: Optional[Routes] = None) -> torch.Tensor:
    """Logits (b, s, vocab) in f32, a sequence at a time; `routes` as in
    `sgd_step`."""
    s = tokens.shape[1]
    with no_tf32():
        return torch.cat([
            matmul(_trunk(params, tokens[r:r + 1], model, precision, False,
                          routes, r * s), params["embed"].t(), precision)
            for r in range(tokens.shape[0])])


# ---- counts -------------------------------------------------------------

def _layer_counts(model: dict) -> Dict[str, int]:
    kinds = _kinds(model)
    return {k: sum(k in pair for pair in kinds)
            for k in ("attention", "conv", "dense", "moe")}


def _expected_rows(model: dict, tokens: int) -> float:
    """Rows each held expert expects a step: t k / n_experts."""
    return tokens * model["experts_per_token"] / model["n_experts"]


def model_flops(model: dict, batch: int, seq: int, train: bool) -> float:
    d, h, kv, dh = _dims(model)
    ff, fe, e = model["d_ff"], model["expert_d_ff"], model["n_experts"]
    n = _layer_counts(model)
    tokens = batch * seq
    per_token = (n["conv"] * 2 * (3 * d * d + d * d)
                 + n["attention"] * 2 * (2 * d * h * dh + 2 * d * kv * dh)
                 + n["dense"] * 2 * 3 * d * ff
                 + n["moe"] * (2 * d * e + 2 * 3 * d * fe
                               * model["experts_per_token"]
                               * model["experts_held"] / e)
                 + 2 * d * model["vocab"])
    attention = n["attention"] * 4 * h * dh * batch * counts.causal_pairs(seq)
    forward = tokens * per_token + attention
    return float(3 * forward if train else forward)


def gemm_work(model: dict, batch: int, seq: int, attention: str,
              train: bool) -> List[counts.Work]:
    """The cuBLAS products at their shapes, and the held experts' grouped
    products at the rows each expects."""
    d, h, kv, dh = _dims(model)
    ff, fe = model["d_ff"], model["expert_d_ff"]
    n = _layer_counts(model)
    t = batch * seq

    def mm(m, k, n_, dtype="bf16", batches=1):
        return counts._with_backward(m, k, n_, dtype, batches, train)

    conv = mm(t, d, 3 * d) + mm(t, d, d)
    attn = (mm(t, d, h * dh) + 2 * mm(t, d, kv * dh) + mm(t, h * dh, d))
    if attention == "einsum":
        attn += mm(seq, dh, seq, batches=batch * h)
        attn += mm(seq, seq, dh, batches=batch * h)
    dense = 2 * mm(t, d, ff) + mm(t, ff, d)
    rows = round(_expected_rows(model, t))
    held = model["experts_held"]
    moe = (mm(t, d, model["n_experts"], "f32")
           + 2 * mm(rows, d, fe, batches=held) + mm(rows, fe, d, batches=held))
    head = mm(t, d, model["vocab"])
    return (conv * n["conv"] + attn * n["attention"] + dense * n["dense"]
            + moe * n["moe"] + head)


def attention_work(model: dict, batch: int, seq: int,
                   train: bool) -> List[counts.Work]:
    """counts.py's attention work over the attention layers alone, at the
    n_heads expanded heads."""
    return counts.attention_work(
        dict(model, n_layers=_layer_counts(model)["attention"]), batch, seq,
        train)
