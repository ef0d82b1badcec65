"""Granite-4.0-H-Small's block (`granitemoehybrid`) as a benchmark
definition (harness/block.py says what a definition holds): its leaves,
its plain float32 reference, how its routes are recorded from the port
and followed, and its counts.

The block, from the published config and the `granitemoehybrid` modelling
code of transformers (GraniteMoeHybridMambaLayer's torch_forward,
GraniteMoeHybridAttention, GraniteMoeHybridMoE, GraniteMoeHybridMLP,
GraniteMoeHybridDecoderLayer): the token embedding times
`embedding_scale`; per layer `x += residual_scale * mixer(RMSNorm(x))`
and `x += residual_scale * (moe(RMSNorm(x)) + shared(RMSNorm(x)))` (one
norm for both), every RMSNorm with a weight (eps `norm_eps`); then a
final RMSNorm and the head tied to the embedding, the logits divided by
`logits_scale`.

- Mamba-2 (`layer_types` "mamba"): `h @ in_proj` split into z (inner =
  mamba_heads x mamba_head_dim), xBC (inner + 2 groups x state) and dt
  (one per head); xBC through the causal depthwise convolution of
  `mamba_taps` taps with its bias, then SiLU, split into x, B and C; dt =
  softplus(dt + dt_bias), A = -exp(A_log); the scan y_t = S_t C_t + D x_t,
  S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, in the published chunked
  form at its mamba_chunk_size (CHUNK, 256); the gated RMSNorm of y
  silu(z) (weight, eps norm_eps), then `@ out_proj`. A_log, dt_bias and D
  are stored as offsets from log 4, softplus^-1(0.01) and 1 (the
  configuration's `assumed`), norm weights as offsets from 1.
- Attention ("attention"): GQA, n_heads query heads over n_kv_heads key
  and value heads of d_model / n_heads, no positions and no q/k norm,
  causal, scores scaled by `attention_scale`, then `@ wo`.
- MoE, every layer: the top `experts_per_token` of the f32 logits `h @
  wr` over `n_experts`, weighted by the softmax over the chosen logits;
  each chosen expert a SwiGLU of width `expert_d_ff`; plus the shared
  expert, one SwiGLU of width `shared_d_ff` on every token. This chip
  holds routed experts 0 .. experts_held - 1 of each layer (the
  configuration's `deployment`): the reference, like the port, computes
  only their part of each token's routed sum, and the shared expert whole.

Leaves and their names are the port's (`layers.` stacked by kind, dim 0
the layer of that kind). The reference is plain PyTorch, importing
nothing of the port and no JAX: float32 with TF32 off at
precision="f32", and its matmuls in fp8 (harness/reference.py's `matmul`)
at "fp8", the control. A training step takes its loss and gradient a
sequence at a time (dropless routing makes each token's result its own,
so this is exact), each layer computed again in the backward, the scan
and the attention a group of heads at a time, each group computed again,
so that the f32 pass fits on one card. Training follows the routes the
port took (`record`); `Routes.gap` is the widest margin by which the
reference's own logits rank an expert it would have chosen above a
followed one.

Counts (`model_flops`, `gemm_work`, `attention_work`,
`attention_work_by_kernel`, as counts.py's and moonlight-16b-a3b.py's, and
`ssd_work`):
- `model_flops`: the matmuls, causal attention once and the scan's
  products (`ssd_work`'s forward) once, the held experts at the rows they
  expect (t k held / n_experts), the shared expert on every token; a
  training step 3 x the forward, not counting remat's second forward.
- `gemm_work`: the cuBLAS and grouped products at the shapes they run,
  with remat's recomputed forward (`model.remat`) in training.
- `attention_work`: attention's own work on the attention layers, as
  moonlight-16b-a3b.py counts it, K1's forward twice a layer under remat.
- `attention_work_by_kernel`: what K1, K2 and K3 each do on the attention
  layers (K1: QK^T and PV; K2: S^T, dP^T, dV, dK; K3: S, dP, dQ), K1
  twice in training under remat, as moonlight-16b-a3b.py's.
- `ssd_work`: the scan's own work, whatever implements it: for each Mamba
  layer the published chunked algorithm's products at CHUNK (C B^T per
  chunk and group; the masked (l, l) products over x, the chunk states,
  the states read by C, each over every head), x, dt, B, C read and y
  written once; in training the backward twice the forward's products,
  reading x, dt, B, C and dy and writing their gradients once, and the
  forward twice a layer under remat.
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

CHUNK = 256                    # the config's mamba_chunk_size
A_LOG = math.log(4.0)          # A_log = A_LOG + leaf
DT_BIAS = math.log(math.expm1(0.01))   # dt_bias = DT_BIAS + leaf
HEAD_GROUP = 8                 # heads of one scan or attention pass
NORMS = ("op_norm", "ffn_norm", "final_norm", "gate_norm")
SCALES = {"conv_w": 0.5, "conv_b": 0.1, "A_log": 0.5, "dt_bias": 0.5,
          "D": 0.1}
NORM_OFFSET_SCALE = 0.1
ATTENTION = ("wq", "wk", "wv", "wo")
MAMBA = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
         "gate_norm", "out_proj")
MOE = ("wr", "w1e", "w3e", "w2e", "ws1", "ws3", "ws2")


def _kinds(model: dict) -> List[str]:
    """Each layer's mixer: "mamba" or "attention"."""
    return ["mamba" if t == "mamba" else "attention"
            for t in model["layer_types"]]


def _widths(model: dict) -> Tuple[int, int, int, int, int]:
    """(heads, head dim, state, groups, inner) of the Mamba mixer."""
    heads, p = model["mamba_heads"], model["mamba_head_dim"]
    return (heads, p, model["mamba_state"], model["mamba_groups"], heads * p)


def leaf_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    d, h, v = model["d_model"], model["n_heads"], model["vocab"]
    kv = model["n_kv_heads"] * (d // h)
    heads, _, n, g, inner = _widths(model)
    xbc = inner + 2 * g * n
    fe, fs = model["expert_d_ff"], model["shared_d_ff"]
    e, held, layers = model["n_experts"], model["experts_held"], model[
        "n_layers"]
    kinds = _kinds(model)
    groups = (
        (kinds.count("attention"), {"wq": (d, d), "wk": (d, kv),
                                    "wv": (d, kv), "wo": (d, d)}),
        (kinds.count("mamba"), {
            "in_proj": (d, inner + xbc + heads),
            "conv_w": (model["mamba_taps"], xbc), "conv_b": (xbc,),
            "dt_bias": (heads,), "A_log": (heads,), "D": (heads,),
            "gate_norm": (inner,), "out_proj": (inner, d)}),
        (layers, {"wr": (d, e), "w1e": (held, d, fe), "w3e": (held, d, fe),
                  "w2e": (held, fe, d), "ws1": (d, fs), "ws3": (d, fs),
                  "ws2": (fs, d)}),
    )
    shapes = {"embed": (v, d)}
    for count, leaves in groups:
        if count:
            shapes.update({f"layers.{k}": (count, *s)
                           for k, s in leaves.items()})
    shapes.update({"layers.op_norm": (layers, d),
                   "layers.ffn_norm": (layers, d), "final_norm": (d,)})
    return shapes


def leaf_scale(model: dict, name: str) -> float:
    key = name.rsplit(".", 1)[-1]
    if key in NORMS:
        return NORM_OFFSET_SCALE
    return SCALES.get(key, model["d_model"] ** -0.5)


# ---- routes -------------------------------------------------------------

class Routes:
    """The top-k experts (t, k) of each MoE layer (by its index) over a
    step's whole batch: recorded (the reference's own, block by block of
    rows) where `follow` is False, followed where True."""

    def __init__(self, by_layer=None, follow: bool = False):
        self.by_layer = dict(by_layer or {})
        self.follow = follow
        self.gap = 0.0
        self._own: Dict[int, Dict[int, torch.Tensor]] = {}

    def pick(self, layer: int, rows: slice, sel: torch.Tensor,
             k: int) -> torch.Tensor:
        """The experts of the batch's `rows`, from the reference's own
        router logits `sel` of those rows."""
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


def _segsum(x):
    """x (..., T) -> (..., T, T): out[i][j] = x[j+1] + .. + x[i] for j <=
    i, -inf above (the modelling code's segment_sum)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    sums = x.masked_fill(~below, 0).cumsum(-2)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return sums.masked_fill(~causal, -torch.inf)


def _scan(x, dt, a, B, C):
    """The chunked scan without D (the modelling code's torch_forward) for
    x (b, s, h, p), dt (b, s, h), a (h,), B and C (b, s, h, n) already by
    head: y (b, s, h, p), f32."""
    b, s, h, p = x.shape
    pad = -s % CHUNK
    c = (s + pad) // CHUNK

    def chunks(t):
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.view(b, c, CHUNK, *t.shape[2:])

    xdt = chunks(x * dt[..., None])                     # (b, c, l, h, p)
    adt = chunks((a * dt)[..., None])[..., 0].permute(0, 3, 1, 2)
    B, C = chunks(B), chunks(C)                         # (b, c, l, h, n)
    cum = adt.cumsum(-1)                                # (b, h, c, l)
    decay = torch.exp(_segsum(adt))                     # (b, h, c, l, l)
    gram = torch.einsum("bclhn,bcshn->bclsh", C, B)
    y_diag = torch.einsum("bclsh,bcshp->bclhp",
                          gram * decay.permute(0, 2, 3, 4, 1), xdt)
    to_end = torch.exp(cum[..., -1:] - cum)             # (b, h, c, l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, to_end, xdt)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], 1)
    across = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, c * CHUNK, h, p)[:, :s]


def _mamba(hidden, w, model, precision):
    b, s, d = hidden.shape
    heads, p, n, g, inner = _widths(model)
    taps = model["mamba_taps"]
    xbc_width = inner + 2 * g * n
    proj = matmul(hidden.reshape(b * s, d), w["in_proj"],
                  precision).view(b, s, -1)
    z, xbc, dt = proj.split([inner, xbc_width, heads], -1)
    xbc = F.conv1d(xbc.transpose(1, 2), w["conv_w"].t()[:, None, :],
                   w["conv_b"], padding=taps - 1, groups=xbc_width)
    xbc = F.silu(xbc[..., :s].transpose(1, 2))
    x, B, C = xbc.split([inner, g * n, g * n], -1)
    x = x.reshape(b, s, heads, p)
    B = B.reshape(b, s, g, n).repeat_interleave(heads // g, 2)
    C = C.reshape(b, s, g, n).repeat_interleave(heads // g, 2)
    dt = F.softplus(dt + DT_BIAS + w["dt_bias"])
    a = -torch.exp(A_LOG + w["A_log"])
    y = torch.cat([checkpoint(_scan, x[:, :, i:i + HEAD_GROUP],
                              dt[..., i:i + HEAD_GROUP],
                              a[i:i + HEAD_GROUP], B[:, :, i:i + HEAD_GROUP],
                              C[:, :, i:i + HEAD_GROUP], use_reentrant=False)
                   for i in range(0, heads, HEAD_GROUP)], 2)
    y = (y + (1 + w["D"])[:, None] * x).reshape(b, s, inner)
    gated = y * F.silu(z)
    gated = _rms(gated, w["gate_norm"], model["norm_eps"])
    return matmul(gated.reshape(b * s, inner), w["out_proj"],
                  precision).view(b, s, d)


def _heads(q, k, v, scale, precision):
    """Causal attention of q, k, v (b, g, s, dh)."""
    s = q.shape[-2]
    scores = matmul(q, k.transpose(-1, -2), precision) * scale
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    return matmul(probs, v, precision)


def _attention(hidden, w, model, precision):
    b, s, d = hidden.shape
    heads, kv = model["n_heads"], model["n_kv_heads"]
    dh = d // heads
    flat = hidden.reshape(b * s, d)

    def split(key, n):
        return matmul(flat, w[key], precision).view(b, s, n, dh).transpose(
            1, 2)

    q = split("wq", heads)
    k = split("wk", kv).repeat_interleave(heads // kv, 1)
    v = split("wv", kv).repeat_interleave(heads // kv, 1)
    attend = partial(_heads, scale=model["attention_scale"],
                     precision=precision)
    o = torch.cat([checkpoint(attend, q[:, i:i + HEAD_GROUP],
                              k[:, i:i + HEAD_GROUP], v[:, i:i + HEAD_GROUP],
                              use_reentrant=False)
                   for i in range(0, heads, HEAD_GROUP)], 1)
    return matmul(o.transpose(1, 2).reshape(b * s, d), w["wo"],
                  precision).view(b, s, d)


def _swiglu(x, w1, w3, w2, precision):
    return matmul(F.silu(matmul(x, w1, precision)) * matmul(x, w3, precision),
                  w2, precision)


def _moe(hidden, w, model, precision, layer=0, routes=None, rows=None,
         first=0):
    """The MoE layer's output: the routed experts held (w1e's first dim,
    the experts first ..), routed over all n_experts by the softmax over
    the chosen logits, and the shared expert; `routes` picks the experts
    of the batch's `rows` (recorded or followed)."""
    b, s, d = hidden.shape
    t, k = b * s, model["experts_per_token"]
    flat = hidden.reshape(t, d)
    logits = matmul(flat, w["wr"], precision)
    chosen = (logits.detach().topk(k, -1).indices if routes is None
              else routes.pick(layer, rows or slice(0, t), logits.detach(),
                               k))
    weights = torch.softmax(logits.gather(1, chosen), -1)
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
    eps, scale = model["norm_eps"], model["residual_scale"]
    hidden = _rms(x, w["op_norm"], eps)
    mixer = _mamba if kind == "mamba" else _attention
    x = x + scale * mixer(hidden, w, model, precision)
    hidden = _rms(x, w["ffn_norm"], eps)
    return x + scale * _moe(hidden, w, model, precision, layer, routes, rows)


def _per_layer(params: Dict[str, torch.Tensor], model: dict):
    """Each layer's kind and {leaf key: its slice}. Unbound once per leaf:
    its backward stacks the slices' gradients once."""
    slices = {name.rsplit(".", 1)[-1]: leaf.unbind(0)
              for name, leaf in params.items() if name.startswith("layers.")}
    taken = {"mamba": 0, "attention": 0}
    out = []
    for i, kind in enumerate(_kinds(model)):
        w = {key: slices[key][i] for key in (*MOE, "op_norm", "ffn_norm")}
        w.update({key: slices[key][taken[kind]]
                  for key in (MAMBA if kind == "mamba" else ATTENTION)})
        out.append((kind, w))
        taken[kind] += 1
    return out


def _trunk(params, tokens, model, precision, remat, routes, row0=0):
    """The final RMSNorm's output (b, s, d) in f32 for tokens (b, s), rows
    row0 .. of the step's batch."""
    x = params["embed"][tokens] * model["embedding_scale"]
    rows = slice(row0, row0 + tokens.numel())
    for layer, (kind, w) in enumerate(_per_layer(params, model)):
        fn = partial(_layer, kind=kind, model=model, precision=precision,
                     layer=layer, routes=routes, rows=rows)
        x = (checkpoint(fn, x, w, use_reentrant=False) if remat
             else fn(x, w))
    return _rms(x, params["final_norm"], model["norm_eps"])


def _nll_sum(h, embed, targets, model, precision):
    logits = matmul(h, embed.t(), precision) / model["logits_scale"]
    return -torch.log_softmax(logits, -1).gather(1, targets[:, None]).sum()


def _sequence_nll(params, tokens, model, precision, routes, row0):
    """The summed next-token NLL of one sequence (1, s)."""
    h = _trunk(params, tokens, model, precision, True, routes, row0)[0, :-1]
    targets = tokens[0, 1:]
    total = h.new_zeros(())
    nll = partial(_nll_sum, model=model, precision=precision)
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
    returns the loss before the update."""
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
            / model["logits_scale"]
            for r in range(tokens.shape[0])])


# ---- counts -------------------------------------------------------------

def _expected_rows(model: dict, tokens: int) -> float:
    """Rows each held expert expects a step: t k / n_experts."""
    return tokens * model["experts_per_token"] / model["n_experts"]


def _scan_flops(model: dict, tokens: int) -> float:
    """The chunked scan's products for `tokens` tokens of one layer's
    forward, at CHUNK: C B^T per group, then per head the masked (l, l)
    product over x, the chunk states and the states read by C."""
    heads, p, n, g, _ = _widths(model)
    return float(2 * tokens * CHUNK * n * g
                 + heads * (2 * tokens * CHUNK * p + 4 * tokens * p * n))


def ssd_work(model: dict, batch: int, seq: int,
             train: bool) -> List[counts.Work]:
    heads, p, n, g, _ = _widths(model)
    t = batch * seq
    inputs = t * (2 * heads * p + 4 * heads + 2 * 2 * g * n)  # x, dt, B, C
    y = 2 * t * heads * p
    fwd = (_scan_flops(model, t), float(inputs + y), "bf16")
    layers = _kinds(model).count("mamba")
    if not train:
        return [fwd] * layers
    bwd = (2 * fwd[0], float(2 * inputs + y), "bf16")
    again = 2 if model.get("remat") else 1
    return ([fwd] * again + [bwd]) * layers


def model_flops(model: dict, batch: int, seq: int, train: bool) -> float:
    d, h, v = model["d_model"], model["n_heads"], model["vocab"]
    kv = model["n_kv_heads"] * (d // h)
    heads, _, n, g, inner = _widths(model)
    fe, fs, e = model["expert_d_ff"], model["shared_d_ff"], model[
        "n_experts"]
    kinds = _kinds(model)
    t = batch * seq
    mamba = 2 * d * (2 * inner + 2 * g * n + heads) + 2 * inner * d
    attention = 2 * d * (2 * d + 2 * kv)
    moe = (2 * d * e + 2 * 3 * d * fs
           + 2 * 3 * d * fe * model["experts_per_token"]
           * model["experts_held"] / e)
    per_token = (kinds.count("mamba") * mamba
                 + kinds.count("attention") * attention
                 + len(kinds) * moe + 2 * d * v)
    scores = (kinds.count("attention") * 2 * h * 2 * (d // h) * batch
              * counts.causal_pairs(seq))
    forward = (t * per_token + scores
               + kinds.count("mamba") * _scan_flops(model, t))
    return float(3 * forward if train else forward)


def gemm_work(model: dict, batch: int, seq: int, attention: str,
              train: bool) -> List[counts.Work]:
    """The cuBLAS products at their shapes, and the held experts' grouped
    products at the rows each expects; in training under `remat` each
    layer's forward products twice (the recomputation in the backward)."""
    d, h = model["d_model"], model["n_heads"]
    kv, dh = model["n_kv_heads"] * (d // h), d // h
    heads, _, n, g, inner = _widths(model)
    fe, fs = model["expert_d_ff"], model["shared_d_ff"]
    kinds = _kinds(model)
    t = batch * seq
    again = train and model.get("remat", False)

    def mm(m, k, n_, dtype="bf16", batches=1):
        out = counts._with_backward(m, k, n_, dtype, batches, train)
        return out + ([counts._mm(m, k, n_, dtype, batches)] if again else [])

    mamba = mm(t, d, 2 * inner + 2 * g * n + heads) + mm(t, inner, d)
    attn = 2 * mm(t, d, d) + 2 * mm(t, d, kv)
    if attention == "einsum":
        attn += mm(seq, dh, seq, batches=batch * h)
        attn += mm(seq, seq, dh, batches=batch * h)
    rows = round(_expected_rows(model, t))
    held = model["experts_held"]
    moe = (mm(t, d, model["n_experts"], "f32")
           + 2 * mm(rows, d, fe, batches=held) + mm(rows, fe, d, batches=held)
           + 2 * mm(t, d, fs) + mm(t, fs, d))
    head = counts._with_backward(t, d, model["vocab"], "bf16", 1, train)
    return (mamba * kinds.count("mamba") + attn * kinds.count("attention")
            + moe * len(kinds) + head)


def attention_work_by_kernel(model: dict, batch: int, seq: int,
                             train: bool) -> Dict[str, List[counts.Work]]:
    """The work of each flash kernel over the attention layers, by the
    trace's kernel group, as moonlight-16b-a3b.py counts it at equal head
    dims dh = d_model / n_heads: K1 `flash_fwd` (QK^T and PV over the
    causal pairs; q, k, v read, o and in training lse written), twice a
    layer in training under remat; K2 `flash_bwd_dkv` (S^T, dP^T, dV, dK;
    q, k, v, dO, lse, D read, dk, dv written) and K3 `flash_bwd_dq` (S,
    dP, dQ; the same read, dq written) in training."""
    h, dh = model["n_heads"], model["d_model"] // model["n_heads"]
    hb = batch * h
    pairs = hb * counts.causal_pairs(seq)
    rows = 4 * hb * seq                          # one f32 per row
    q = 2 * hb * seq * dh                        # bf16 bytes of q
    layers = _kinds(model).count("attention")
    fwd = (4.0 * pairs * dh, float(4 * q + (rows if train else 0)), "bf16")
    work = {"flash_fwd": [fwd] * layers * (2 if train and model.get("remat")
                                           else 1)}
    if train:
        reads = 4 * q + 2 * rows
        work["flash_bwd_dkv"] = [(8.0 * pairs * dh, float(reads + 2 * q),
                                  "bf16")] * layers
        work["flash_bwd_dq"] = [(6.0 * pairs * dh, float(reads + q),
                                 "bf16")] * layers
    return work


def attention_work(model: dict, batch: int, seq: int,
                   train: bool) -> List[counts.Work]:
    """Attention's own work over the attention layers (counts.py's
    yardstick, as moonlight-16b-a3b.py counts it at equal head dims
    d_model / n_heads): K1's forward per run, so twice a layer in training
    under remat; the backward's dV, dP, dK, dQ (2 dh FLOPs a pair each),
    q, k, v, o, dO read, dq, dk, dv written, once, without S, which K2
    and K3 each recompute, or K3's second dP."""
    h, dh = model["n_heads"], model["d_model"] // model["n_heads"]
    hb = batch * h
    pairs = hb * counts.causal_pairs(seq)
    q = 2 * hb * seq * dh                        # bf16 bytes of q
    work = list(attention_work_by_kernel(model, batch, seq, train)
                ["flash_fwd"])
    if train:
        work += [(8.0 * pairs * dh, float(8 * q + 4 * hb * seq), "bf16")
                 ] * _kinds(model).count("attention")
    return work
