"""Moonlight-16B-A3B's block (DeepSeek-V3's) as a benchmark definition
(harness/block.py says what a definition holds): its leaves, its plain
float32 reference, how its routes are recorded from the port and
followed, and its counts.

The block, from the published config and the `deepseek_v3` modelling
code of transformers (DeepseekV3Attention, DeepseekV3MoE,
DeepseekV3TopkRouter): the token embedding; per layer
`x += attention(RMSNorm(x))` and `x += mlp(RMSNorm(x))`, every RMSNorm
with a weight (eps `norm_eps`, the config's rms_norm_eps); then a final
RMSNorm and an untied head (logits = h @ unembed).

- Attention, multi-head latent (MLA) without a query LoRA: `q = h @
  q_proj`, n_heads heads of qk_nope_head_dim + qk_rope_head_dim;
  `h @ kv_a` gives the latent (kv_lora_rank) and one RoPE key of
  qk_rope_head_dim shared by every head; the latent through its own
  RMSNorm (kv_a_layernorm, weight 1 + kv_norm, eps 1e-6: the norm's
  default, not rms_norm_eps), then `@ kv_b` into each head's key without
  RoPE and its value (v_head_dim). RoPE (`rope_theta`, over the
  qk_rope_head_dim dims) on q's rope dims and on the shared key, in the
  published interleaved form: the even dims moved before the odd ones,
  then the halves turned. Causal, scale (qk_nope + qk_rope) ** -0.5 (no
  rope_scaling, so no mscale), then `@ o_proj`.
- MLP: SwiGLU, `w2(silu(w1 x) * w3 x)`, width `d_ff` in the first
  `n_dense_layers`; after them the MoE: scores s = sigmoid(x @ wr) over
  `n_experts`, the `experts_per_token` largest s + moe_bias chosen (the
  bias selects only; one group, so the group-limited choice keeps every
  expert), their weights the chosen s over their sum + `router_eps`
  (norm_topk_prob), times `routed_scale`; each chosen expert a SwiGLU of
  width `expert_d_ff`; plus the shared experts, one SwiGLU of width
  `shared_d_ff` on every token. This chip holds routed experts
  0 .. experts_held - 1 of each layer (the configuration's
  `deployment`): the reference, like the port, computes only their part
  of each token's routed sum, and the shared experts whole.
- Norm weights are leaves of offsets, w = 1 + g.

Leaves and their names are the port's (`layers.` stacked by kind, dim 0
the layer of that kind). The reference is plain PyTorch, importing
nothing of the port and no JAX: float32 with TF32 off at
precision="f32", and its matmuls in fp8 (harness/reference.py's `matmul`)
at "fp8", the control. A training step takes its loss and gradient a
sequence at a time (dropless routing makes each token's result its own,
so this is exact), each layer computed again in the backward, and the
attention a group of heads at a time, so that the f32 pass fits on one
card. Training follows the routes the port took (`record`); `Routes.gap`
is the widest margin by which the reference's own s + bias ranks an
expert it would have chosen above a followed one.

Counts (`model_flops`, `gemm_work`, `attention_work`, as counts.py's, and
`attention_work_by_kernel`):
- `model_flops`: the matmuls and causal attention once (QK^T at the
  query/key head dim, PV at the value head dim), the held experts at the
  rows they expect (t k held / n_experts), the shared experts on every
  token; a training step 3 x the forward, not counting remat's second
  forward.
- `gemm_work`: the cuBLAS and grouped products at the shapes they run,
  with remat's recomputed forward (`model.remat`) in training.
- `attention_work`: attention's own work whatever kernels run it, as
  counts.py counts it for the other cells, each product at its own head
  dim: a forward (QK^T, PV) per forward run, so twice a layer in training
  under remat; a backward of dV, dP, dK and dQ once a layer; q, k, v and o
  once (backward: q, k, v, o, dO and lse read, dq, dk, dv written).
- `attention_work_by_kernel`: what K1, K2 and K3 each do (K1: QK^T and
  PV; K2: S^T, dP^T, dV, dK; K3: S, dP, dQ), K1 twice in training under
  remat. Their sum is `attention_work`, S recomputed in K2 and in K3, and
  dP made a second time in K3.
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
# selection bias, small enough to leave the experts held near their
# share 8 / 64 of the pairs over seeds and large enough to move near-ties
NORM_OFFSET_SCALE = 0.1
BIAS_SCALE = 0.005
LATENT_EPS = 1e-6              # kv_a_layernorm's (DeepseekV3RMSNorm default)
HEAD_GROUP = 4                 # heads of one attention pass of the reference
NORMS = ("kv_norm", "op_norm", "ffn_norm", "final_norm")
MLA = ("q_proj", "kv_a", "kv_norm", "kv_b", "o_proj")
MOE = ("wr", "w1e", "w3e", "w2e", "moe_bias", "ws1", "ws3", "ws2")
DENSE = ("w1", "w3", "w2")


def _kinds(model: dict) -> List[str]:
    """Each layer's MLP: "dense" or "moe"."""
    return ["dense" if i < model["n_dense_layers"] else "moe"
            for i in range(model["n_layers"])]


def _qk(model: dict) -> int:
    return model["qk_nope_head_dim"] + model["qk_rope_head_dim"]


def leaf_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    d, h, v = model["d_model"], model["n_heads"], model["vocab"]
    lat, r = model["kv_lora_rank"], model["qk_rope_head_dim"]
    nope, dv = model["qk_nope_head_dim"], model["v_head_dim"]
    ff, fe, fs = model["d_ff"], model["expert_d_ff"], model["shared_d_ff"]
    e, held, n = model["n_experts"], model["experts_held"], model["n_layers"]
    kinds = _kinds(model)
    n_moe, n_dense = kinds.count("moe"), kinds.count("dense")
    shapes = {"embed": (v, d), "unembed": (d, v)}
    groups = (
        (n, {"q_proj": (d, h * _qk(model)), "kv_a": (d, lat + r),
             "kv_norm": (lat,), "kv_b": (lat, h * (nope + dv)),
             "o_proj": (h * dv, d)}),
        (n_moe, {"wr": (d, e), "w1e": (held, d, fe), "w3e": (held, d, fe),
                 "w2e": (held, fe, d), "moe_bias": (e,), "ws1": (d, fs),
                 "ws3": (d, fs), "ws2": (fs, d)}),
        (n_dense, {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}),
    )
    for count, leaves in groups:
        shapes.update({f"layers.{k}": (count, *s) for k, s in leaves.items()})
    shapes.update({"layers.op_norm": (n, d), "layers.ffn_norm": (n, d),
                   "final_norm": (d,)})
    return shapes


def leaf_scale(model: dict, name: str) -> float:
    key = name.rsplit(".", 1)[-1]
    if key in NORMS:
        return NORM_OFFSET_SCALE
    if key == "moe_bias":
        return BIAS_SCALE
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


def _rope_interleaved(x, theta):
    """x (b, heads, s, r) turned by RoPE as the published code does with
    rope_interleave: the dims reordered evens first, odds after, then the
    halves turned by position p x theta ** (-2i / r)."""
    b, heads, s, r = x.shape
    x = x.view(b, heads, s, r // 2, 2).transpose(4, 3).reshape(b, heads, s, r)
    inv = theta ** -(torch.arange(0, r, 2, device=x.device,
                                  dtype=torch.float32) / r)
    angle = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    angle = torch.cat([angle, angle], -1)
    x1, x2 = x.chunk(2, -1)
    return x * angle.cos() + torch.cat([-x2, x1], -1) * angle.sin()


def _heads(q, k, v, scale, precision):
    """Causal attention of q, k (b, g, s, qk) over v (b, g, s, dv)."""
    s = q.shape[-2]
    scores = matmul(q, k.transpose(-1, -2), precision) * scale
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    return matmul(probs, v, precision)


def _mla(h, w, model, precision):
    b, s, d = h.shape
    heads, lat = model["n_heads"], model["kv_lora_rank"]
    nope, r = model["qk_nope_head_dim"], model["qk_rope_head_dim"]
    flat = h.reshape(b * s, d)
    q = matmul(flat, w["q_proj"], precision).view(b, s, heads, -1)
    q = q.transpose(1, 2)
    q_pass, q_rot = q.split([nope, r], -1)
    compressed = matmul(flat, w["kv_a"], precision).view(b, s, -1)
    latent, k_rot = compressed.split([lat, r], -1)
    latent = _rms(latent, w["kv_norm"], LATENT_EPS)
    kv = matmul(latent.reshape(b * s, lat), w["kv_b"], precision)
    kv = kv.view(b, s, heads, -1).transpose(1, 2)
    k_pass, v = kv.split([nope, model["v_head_dim"]], -1)
    q_rot = _rope_interleaved(q_rot, model["rope_theta"])
    k_rot = _rope_interleaved(k_rot.view(b, 1, s, r), model["rope_theta"])
    q = torch.cat([q_pass, q_rot], -1)
    k = torch.cat([k_pass, k_rot.expand(b, heads, s, r)], -1)
    scale = _qk(model) ** -0.5
    attend = partial(_heads, scale=scale, precision=precision)
    o = torch.cat([checkpoint(attend, q[:, g:g + HEAD_GROUP],
                              k[:, g:g + HEAD_GROUP], v[:, g:g + HEAD_GROUP],
                              use_reentrant=False)
                   for g in range(0, heads, HEAD_GROUP)], 1)
    return matmul(o.transpose(1, 2).reshape(b * s, -1), w["o_proj"],
                  precision).view(b, s, d)


def _swiglu(x, w1, w3, w2, precision):
    return matmul(F.silu(matmul(x, w1, precision)) * matmul(x, w3, precision),
                  w2, precision)


def _moe(h, w, model, precision, layer=0, routes=None, rows=None, first=0):
    """The MoE layer's output: the routed experts held (w1e's first dim,
    the experts first ..), routed over all n_experts, and the shared
    experts; `routes` picks the experts of the batch's `rows` (recorded or
    followed)."""
    b, s, d = h.shape
    t, k = b * s, model["experts_per_token"]
    flat = h.reshape(t, d)
    scores = torch.sigmoid(matmul(flat, w["wr"], precision))
    sel = scores.detach() + w["moe_bias"].detach()
    chosen = (sel.topk(k, -1).indices if routes is None
              else routes.pick(layer, rows or slice(0, t), sel, k))
    weights = scores.gather(1, chosen)
    weights = weights / (weights.sum(-1, keepdim=True) + model["router_eps"])
    weights = weights * model["routed_scale"]
    out = flat.new_zeros(t, d)
    for e in range(w["w1e"].shape[0]):
        hit = chosen == first + e
        tokens = torch.nonzero(hit.any(-1)).flatten()
        if tokens.numel():
            y = _swiglu(flat[tokens], w["w1e"][e], w["w3e"][e], w["w2e"][e],
                        precision)
            out = out.index_add(0, tokens,
                                y * (weights * hit).sum(-1)[tokens, None])
    shared = _swiglu(flat, w["ws1"], w["ws3"], w["ws2"], precision)
    return (out + shared).view(b, s, d)


def _layer(x, w, kind, model, precision, layer, routes, rows):
    eps = model["norm_eps"]
    x = x + _mla(_rms(x, w["op_norm"], eps), w, model, precision)
    h = _rms(x, w["ffn_norm"], eps)
    if kind == "dense":
        b, s, d = h.shape
        return x + _swiglu(h.reshape(b * s, d), w["w1"], w["w3"], w["w2"],
                           precision).view(b, s, d)
    return x + _moe(h, w, model, precision, layer, routes, rows)


def _per_layer(params: Dict[str, torch.Tensor], model: dict):
    """Each layer's kind, its index among the MoE layers, and {leaf key:
    its slice}. Unbound once per leaf: its backward stacks the slices'
    gradients once, where each index's would add a zero gradient of the
    whole stack."""
    slices = {name.rsplit(".", 1)[-1]: leaf.unbind(0)
              for name, leaf in params.items() if name.startswith("layers.")}
    taken = {"dense": 0, "moe": 0}
    out = []
    for i, kind in enumerate(_kinds(model)):
        w = {key: slices[key][i] for key in (*MLA, "op_norm", "ffn_norm")}
        w.update({key: slices[key][taken[kind]]
                  for key in (MOE if kind == "moe" else DENSE)})
        out.append((kind, taken["moe"], w))
        taken[kind] += 1
    return out


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


def _nll_sum(h, unembed, targets, precision):
    logits = matmul(h, unembed, precision)
    return -torch.log_softmax(logits, -1).gather(1, targets[:, None]).sum()


def _sequence_nll(params, tokens, model, precision, routes, row0):
    """The summed next-token NLL of one sequence (1, s)."""
    h = _trunk(params, tokens, model, precision, True, routes, row0)[0, :-1]
    targets = tokens[0, 1:]
    total = h.new_zeros(())
    nll = partial(_nll_sum, precision=precision)
    for start in range(0, h.shape[0], HEAD_ROWS):
        block = slice(start, start + HEAD_ROWS)
        total = total + checkpoint(nll, h[block], params["unembed"],
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
                          routes, r * s), params["unembed"], precision)
            for r in range(tokens.shape[0])])


# ---- counts -------------------------------------------------------------

def _expected_rows(model: dict, tokens: int) -> float:
    """Rows each held expert expects a step: t k / n_experts."""
    return tokens * model["experts_per_token"] / model["n_experts"]


def model_flops(model: dict, batch: int, seq: int, train: bool) -> float:
    d, h = model["d_model"], model["n_heads"]
    lat, r = model["kv_lora_rank"], model["qk_rope_head_dim"]
    nope, dv = model["qk_nope_head_dim"], model["v_head_dim"]
    ff, fe, fs, e = (model["d_ff"], model["expert_d_ff"],
                     model["shared_d_ff"], model["n_experts"])
    kinds = _kinds(model)
    per_token = (len(kinds) * 2 * (d * h * _qk(model) + d * (lat + r)
                                   + lat * h * (nope + dv) + h * dv * d)
                 + kinds.count("dense") * 2 * 3 * d * ff
                 + kinds.count("moe") * (2 * d * e + 2 * 3 * d * fs
                                         + 2 * 3 * d * fe
                                         * model["experts_per_token"]
                                         * model["experts_held"] / e)
                 + 2 * d * model["vocab"])
    attention = (len(kinds) * 2 * h * (_qk(model) + dv) * batch
                 * counts.causal_pairs(seq))
    forward = batch * seq * per_token + attention
    return float(3 * forward if train else forward)


def gemm_work(model: dict, batch: int, seq: int, attention: str,
              train: bool) -> List[counts.Work]:
    """The cuBLAS products at their shapes, and the held experts' grouped
    products at the rows each expects; in training under `remat` each
    layer's forward products twice (the recomputation in the backward)."""
    d, h = model["d_model"], model["n_heads"]
    lat, r = model["kv_lora_rank"], model["qk_rope_head_dim"]
    nope, dv, qk = model["qk_nope_head_dim"], model["v_head_dim"], _qk(model)
    ff, fe, fs = model["d_ff"], model["expert_d_ff"], model["shared_d_ff"]
    kinds = _kinds(model)
    t = batch * seq
    again = train and model.get("remat", False)

    def mm(m, k, n_, dtype="bf16", batches=1):
        out = counts._with_backward(m, k, n_, dtype, batches, train)
        return out + ([counts._mm(m, k, n_, dtype, batches)] if again else [])

    mla = (mm(t, d, h * qk) + mm(t, d, lat + r) + mm(t, lat, h * (nope + dv))
           + mm(t, h * dv, d))
    if attention == "einsum":
        mla += mm(seq, qk, seq, batches=batch * h)
        mla += mm(seq, seq, dv, batches=batch * h)
    dense = 2 * mm(t, d, ff) + mm(t, ff, d)
    rows = round(_expected_rows(model, t))
    held = model["experts_held"]
    moe = (mm(t, d, model["n_experts"], "f32")
           + 2 * mm(rows, d, fe, batches=held) + mm(rows, fe, d, batches=held)
           + 2 * mm(t, d, fs) + mm(t, fs, d))
    head = counts._with_backward(t, d, model["vocab"], "bf16", 1, train)
    return (mla * len(kinds) + dense * kinds.count("dense")
            + moe * kinds.count("moe") + head)


def attention_work_by_kernel(model: dict, batch: int, seq: int,
                             train: bool) -> Dict[str, List[counts.Work]]:
    """The work of each flash kernel over the step's layers, by the trace's
    kernel group: K1 `flash_fwd` (QK^T at the query/key head dim and PV at
    the value head dim over the causal pairs; q, k, v read, o and in
    training lse written), run twice a layer in training under remat;
    K2 `flash_bwd_dkv` (S^T, dP^T, dV, dK; q, k, v, dO, lse, D read, dk, dv
    written) and K3 `flash_bwd_dq` (S, dP, dQ; the same read, dq written)
    in training."""
    h, qk, dv = model["n_heads"], _qk(model), model["v_head_dim"]
    hb = batch * h
    pairs = hb * counts.causal_pairs(seq)
    rows = 4 * hb * seq                          # one f32 per row
    q, v = 2 * hb * seq * qk, 2 * hb * seq * dv  # bf16 bytes of q and of v
    n = model["n_layers"]
    fwd = (2.0 * pairs * (qk + dv),
           float(2 * q + 2 * v + (rows if train else 0)), "bf16")
    work = {"flash_fwd": [fwd] * n * (2 if train and model.get("remat")
                                      else 1)}
    if train:
        reads = 2 * q + 2 * v + 2 * rows
        work["flash_bwd_dkv"] = [(2.0 * pairs * 2 * (qk + dv),
                                  float(reads + q + v), "bf16")] * n
        work["flash_bwd_dq"] = [(2.0 * pairs * (2 * qk + dv),
                                 float(reads + q), "bf16")] * n
    return work


def attention_work(model: dict, batch: int, seq: int,
                   train: bool) -> List[counts.Work]:
    """Attention's own work over the step's layers (counts.py's yardstick
    at unequal head dims): the forward per run, K1's work; the backward
    dV, dP (2 d_v FLOPs a pair each), dK, dQ (2 d_qk each), without S,
    which K2 and K3 each recompute, or K3's second dP."""
    h, qk, dv = model["n_heads"], _qk(model), model["v_head_dim"]
    hb = batch * h
    pairs = hb * counts.causal_pairs(seq)
    q, v = 2 * hb * seq * qk, 2 * hb * seq * dv  # bf16 bytes of q and of v
    work = list(attention_work_by_kernel(model, batch, seq, train)
                ["flash_fwd"])
    if train:
        work += [(2.0 * pairs * 2 * (qk + dv),
                  float(4 * q + 4 * v + 4 * hb * seq), "bf16")
                 ] * model["n_layers"]
    return work
