"""Operations and bytes of the port's model step, worked out from shapes.

`model` is a configuration's `model` block (vocab, d_model, n_heads, d_ff,
n_layers, n_experts, capacity_factor). A unit of work is one training step
or one scored request over a (batch, seq) token block.

- `model_flops`: the matmuls the step requires and nothing else: the q, k,
  v and o projections, causal attention counted once (QK^T and PV over the
  seq (seq + 1) / 2 causal pairs), the MLP (for MoE the router and one
  expert per token), and the unembedding; not the embedding gather. A
  training step is 3 x the forward. MoE tokens dropped at capacity are
  counted: the port has no counter of the kept ones yet.
- `gemm_work`: each matmul that cuBLAS runs, at the shapes it runs them
  (the MoE experts over their capacity-padded buffers, einsum attention
  over the full score square), forward and, for training, both backward
  products, with operands read and results written once.
- `attention_work`: attention's own work whatever kernel runs it: causal
  FLOPs, q, k, v read and o written once (backward: q, k, v, o, dO and
  the logsumexp read, dq, dk, dv written).
Each piece of work is (flops, bytes, dtype); `bound_s` turns a list of them
into the least time the card could take.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference import capacity

Work = Tuple[float, float, str]

BYTES = {"bf16": 2, "f32": 4}


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def model_flops(model: dict, batch: int, seq: int, train: bool) -> float:
    d, ff, vocab = model["d_model"], model["d_ff"], model["vocab"]
    experts = model.get("n_experts", 0)
    tokens = batch * seq
    per_token = 2 * 4 * d * d + 2 * 2 * d * ff + (2 * d * experts
                                                  if experts else 0)
    attention = 4 * d * batch * causal_pairs(seq)
    forward = (model["n_layers"] * (tokens * per_token + attention)
               + 2 * d * vocab * tokens)
    return float(3 * forward if train else forward)


def _mm(m: int, k: int, n: int, dtype: str, batches: int = 1) -> Work:
    """(m, k) @ (k, n), `batches` times."""
    e = BYTES[dtype]
    return (2.0 * batches * m * k * n,
            float(e * batches * (m * k + k * n + m * n)), dtype)


def _with_backward(m: int, k: int, n: int, dtype: str, batches: int,
                   train: bool) -> List[Work]:
    """A product and, in training, its two backward products: dA = dC B^T
    (m, n) @ (n, k) and dB = A^T dC (k, m) @ (m, n)."""
    out = [_mm(m, k, n, dtype, batches)]
    if train:
        out += [_mm(m, n, k, dtype, batches), _mm(k, m, n, dtype, batches)]
    return out


def gemm_work(model: dict, batch: int, seq: int, attention: str,
              train: bool) -> List[Work]:
    d, ff, h = model["d_model"], model["d_ff"], model["n_heads"]
    experts = model.get("n_experts", 0)
    dh, t = d // h, batch * seq
    layer: List[Work] = []
    for _ in range(4):                       # wq, wk, wv, wo
        layer += _with_backward(t, d, d, "bf16", 1, train)
    if attention == "einsum":
        layer += _with_backward(seq, dh, seq, "bf16", batch * h, train)
        layer += _with_backward(seq, seq, dh, "bf16", batch * h, train)
    if experts:
        slots = min(capacity(t, experts, model["capacity_factor"]), t)
        layer += _with_backward(t, d, experts, "f32", 1, train)   # router
        layer += _with_backward(slots, d, ff, "bf16", experts, train)
        layer += _with_backward(slots, ff, d, "bf16", experts, train)
    else:
        layer += _with_backward(t, d, ff, "bf16", 1, train)
        layer += _with_backward(t, ff, d, "bf16", 1, train)
    head = _with_backward(t, d, model["vocab"], "bf16", 1, train)
    return layer * model["n_layers"] + head


def attention_work(model: dict, batch: int, seq: int,
                   train: bool) -> List[Work]:
    d, h = model["d_model"], model["n_heads"]
    dh, hb = d // h, batch * model["n_heads"]
    pairs, tile = causal_pairs(seq), hb * seq * dh
    lse = 4 * hb * seq if train else 0
    work = [(4.0 * hb * dh * pairs, float(2 * 4 * tile + lse), "bf16")]
    if train:
        work.append((8.0 * hb * dh * pairs,
                     float(2 * 8 * tile + 4 * hb * seq), "bf16"))
    return work * model["n_layers"]


def bound_s(work: List[Work], peak) -> float:
    """The least time for `work` on a card with `peak` (peaks.Peak): per
    piece, the larger of its FLOPs over the dtype's peak and its bytes
    over the memory bandwidth, summed."""
    return sum(max(f / peak.flops(dtype), b / peak.hbm_bytes)
               for f, b, dtype in work)
