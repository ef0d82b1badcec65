"""Transformer burn-in workload in PyTorch: serving and training.

Port of `tpu_device_plugin/validator/workload.py` for one CUDA device:
embedding, RMSNorm, multi-head causal attention, GELU MLP, unembedding,
cross-entropy, and SGD with momentum.

- Weights keep the JAX layout: `(in, out)` matrices used as `x @ W`,
  stacked on a leading n_layers dim, under `embed`, `unembed` and
  `layers.{wq,wk,wv,wo,w1,w2}`; weights from the JAX package load with
  `params_from_jax`.
- Every matmul runs in bfloat16 (weights are cast at the matmul, as the
  JAX forward does); RMSNorm and the logits are float32; params, grads
  and momentum are float32.
- Attention is `flash` (the CUDA kernels in csrc/, forward and backward;
  their plain versions on the CPU) or `einsum`. Ring attention, the mesh
  and MoE come in later slices (ROADMAP.md, Queue 1).

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    d_ff: int = 512
    n_layers: int = 2
    seq_len: int = 128
    batch: int = 8
    lr: float = 1e-2
    momentum: float = 0.9
    # Mixture-of-experts: 0 = dense MLP; >0 is the top-1 switch layer,
    # which is not ported yet (init_params makes its weights, the forward
    # refuses it)
    n_experts: int = 0
    capacity_factor: float = 1.25
    # recompute each layer's activations in the backward instead of
    # keeping them (torch.utils.checkpoint; the JAX version's jax.checkpoint)
    remat: bool = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says otherwise.

    Raises RuntimeError when CUDA is wanted and absent; never falls back
    to the CPU silently."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: this entry point runs on the card unless "
            "the caller passes device='cpu'")
    return dev


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Params:
    """f32 weights ~ N(0, 1) * d_model ** -0.5, stacked on n_layers, drawn
    from `generator` (which must live on `device`)."""
    dev = resolve_device(device)
    scale = cfg.d_model ** -0.5
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev) * scale

    embed, unembed = dense(cfg.vocab, d), dense(d, cfg.vocab)
    layers = {"wq": dense(L, d, d), "wk": dense(L, d, d),
              "wv": dense(L, d, d), "wo": dense(L, d, d)}
    if E:
        layers["wr"] = dense(L, d, E)
        layers["w1e"] = dense(L, E, d, ff)
        layers["w2e"] = dense(L, E, ff, d)
    else:
        layers["w1"] = dense(L, d, ff)
        layers["w2"] = dense(L, ff, d)
    return {"embed": embed, "unembed": unembed, "layers": layers}


def params_from_jax(tree, device=None) -> Params:
    """The port's params from a JAX param tree given as numpy arrays
    (`jax.tree.map(np.asarray, params)`). Every key is copied as it is,
    so any layer key (MoE's wr/w1e/w2e too) passes through."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_jax(val, dev) for key, val in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _fold_heads(t: torch.Tensor) -> torch.Tensor:
    bl, sl, hl, dl = t.shape
    return t.transpose(1, 2).reshape(bl * hl, sl, dl)


def _unfold_heads(t: torch.Tensor, bl: int, hl: int) -> torch.Tensor:
    _, sl, dl = t.shape
    return t.reshape(bl, hl, sl, dl).transpose(1, 2)


def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.to(torch.bfloat16)


def _attention(x: torch.Tensor, layer: Params, cfg: ModelConfig,
               attention: str = "einsum") -> torch.Tensor:
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    q = (x @ _bf16(layer["wq"])).reshape(b, s, h, dh)
    k = (x @ _bf16(layer["wk"])).reshape(b, s, h, dh)
    v = (x @ _bf16(layer["wv"])).reshape(b, s, h, dh)
    if attention == "ring":
        raise NotImplementedError(
            "ring attention is not yet ported (ROADMAP.md, Queue 1, item 4)")
    if attention == "flash":
        from .flash_attention import flash_attention
        o = flash_attention(_fold_heads(q).contiguous(),
                            _fold_heads(k).contiguous(),
                            _fold_heads(v).contiguous(), None, True)
        out = _unfold_heads(o, b, h).reshape(b, s, d)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (dh ** -0.5)
        mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask, scores, -1e9)
        probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
    return out @ _bf16(layer["wo"])


def _mlp(x: torch.Tensor, layer: Params) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    hidden = F.gelu(x @ _bf16(layer["w1"]), approximate="tanh")
    return hidden @ _bf16(layer["w2"])


def _rms_norm(x: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    # bf16 x times an f32 rsqrt promotes to f32, as in the JAX version
    return (x * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _layer_body(x: torch.Tensor, layer: Params, cfg: ModelConfig,
                attention: str) -> torch.Tensor:
    """One transformer block (attention + MLP residuals), dense only."""
    if cfg.n_experts:
        raise NotImplementedError(
            "the MoE layer is not yet ported (ROADMAP.md, Queue 1, item 5)")
    x = x + _attention(_rms_norm(x), layer, cfg, attention)
    return x + _mlp(_rms_norm(x), layer)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attention: str = "einsum") -> torch.Tensor:
    """Logits (batch, seq, vocab) in f32."""
    x = _bf16(params["embed"])[tokens]
    # unbind, not w[i]: its backward stacks the layers' grads once, where
    # each w[i]'s would fill and add a zero grad of the whole stack
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][name].unbind(0) for name in names))
    for weights in per_layer:
        layer = dict(zip(names, weights))
        if cfg.remat:
            x = checkpoint(_layer_body, x, layer, cfg, attention,
                           use_reentrant=False)
        else:
            x = _layer_body(x, layer, cfg, attention)
    logits = _rms_norm(x) @ _bf16(params["unembed"])
    return logits.float()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attention: str = "einsum") -> torch.Tensor:
    """Mean next-token cross-entropy."""
    logits = forward(params, tokens, cfg, attention)
    logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logprobs, -1, tokens[:, 1:, None].long())
    return nll.mean()


def _named_leaves(tree: Params, prefix: str = ""
                  ) -> List[Tuple[str, torch.Tensor]]:
    """(dotted key, tensor) of each tensor of a param tree, in sorted-key
    order."""
    if isinstance(tree, dict):
        return [kv for key in sorted(tree)
                for kv in _named_leaves(tree[key], f"{prefix}{key}.")]
    return [(prefix[:-1], tree)]


def _leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a param tree, in sorted-key order."""
    return [t for _, t in _named_leaves(tree)]


def _with_leaves(tree: Params, leaves) -> Params:
    """A tree of `tree`'s structure holding `leaves` (in `_leaves` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)
    return build(tree)


def value_and_grad(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   attention: str = "einsum") -> Tuple[torch.Tensor, Params]:
    """(loss, grads) with grads a tree of params' structure; the caller's
    params are not marked as requiring grad."""
    leaves = [p.detach().requires_grad_() for p in _leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_with_leaves(params, leaves), tokens, cfg, attention)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _with_leaves(params, grads)


def sgd_step(params: Params, momentum: Params, tokens: torch.Tensor,
             cfg: ModelConfig, attention: str = "einsum"
             ) -> Tuple[Params, Params, torch.Tensor]:
    """One training step: loss, grads, SGD with momentum.

    m <- momentum * m + g, p <- p - lr * m. params and momentum are updated
    in place (the JAX version donates them) and returned with the loss,
    which is the loss before the update."""
    loss, grads = value_and_grad(params, tokens, cfg, attention)
    with torch.no_grad():
        for p, m, g in zip(_leaves(params), _leaves(momentum), _leaves(grads)):
            m.mul_(cfg.momentum).add_(g)
            p.sub_(m, alpha=cfg.lr)
    return params, momentum, loss


def _resolve(cfg: Optional[ModelConfig], attention: Optional[str], device):
    """Config, device and attention mode for a build on one device.

    None auto-selects the flash kernel on CUDA and einsum on the CPU; the
    seq-length crossover between the two on the card is not measured yet."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    if attention is None:
        attention = "flash" if dev.type == "cuda" else "einsum"
    if attention not in ("flash", "ring", "einsum"):
        raise ValueError(f"unknown attention mode {attention!r}")
    return cfg, dev, attention


def _place(cfg: ModelConfig, dev: torch.device, seed: int):
    """Params from a generator seeded with `seed`, a token batch from one
    seeded with `seed + 1`, both on `dev`."""
    params = init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                           generator=torch.Generator(dev).manual_seed(seed + 1),
                           device=dev)
    return params, tokens


def build_workload(cfg: Optional[ModelConfig] = None, seed: int = 0,
                   attention: Optional[str] = None, device=None):
    """Training build on one device.

    Returns (step, params, momentum, tokens): `step(params, momentum,
    tokens) -> (params, momentum, loss)` is `sgd_step`, which updates its
    arguments in place; params and tokens are seeded as in `build_infer`;
    momentum starts at zero."""
    cfg, dev, attention = _resolve(cfg, attention, device)
    params, tokens = _place(cfg, dev, seed)
    momentum = _with_leaves(params, [torch.zeros_like(p)
                                     for p in _leaves(params)])

    def step(p: Params, m: Params, t: torch.Tensor):
        return sgd_step(p, m, t, cfg, attention)

    return step, params, momentum, tokens


def build_infer(cfg: Optional[ModelConfig] = None, seed: int = 0,
                attention: Optional[str] = None, device=None):
    """Serving-path build on one device.

    Returns (forward fn -> logits, params, tokens): params from a generator
    seeded with `seed`, a token batch from one seeded with `seed + 1`. The
    forward runs without autograd and can be called repeatedly."""
    cfg, dev, attention = _resolve(cfg, attention, device)
    params, tokens = _place(cfg, dev, seed)

    @torch.no_grad()
    def fwd(p: Params, t: torch.Tensor) -> torch.Tensor:
        return forward(p, t, cfg, attention)

    return fwd, params, tokens
