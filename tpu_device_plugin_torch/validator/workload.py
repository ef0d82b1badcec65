"""Transformer burn-in workload, serving half, in PyTorch.

Port of `tpu_device_plugin/validator/workload.py` for one CUDA device:
embedding, RMSNorm, multi-head causal attention, GELU MLP, unembedding.

- Weights keep the JAX layout: `(in, out)` matrices used as `x @ W`,
  stacked on a leading n_layers dim, under `embed`, `unembed` and
  `layers.{wq,wk,wv,wo,w1,w2}`; weights from the JAX package load with
  `params_from_jax`.
- Every matmul runs in bfloat16 (weights are cast at the matmul, as the
  JAX forward does); RMSNorm and the logits are float32.
- Attention is `flash` (the CUDA kernel in csrc/flash_fwd.cu, its plain
  version on the CPU) or `einsum`. Ring attention, the mesh, MoE and
  training come in later slices (ROADMAP.md, Queue 1).

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    for i in range(cfg.n_layers):
        layer = {name: w[i] for name, w in params["layers"].items()}
        x = _layer_body(x, layer, cfg, attention)
    logits = _rms_norm(x) @ _bf16(params["unembed"])
    return logits.float()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attention: str = "einsum") -> torch.Tensor:
    """Mean next-token cross-entropy (forward only in this slice)."""
    logits = forward(params, tokens, cfg, attention)
    logprobs = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logprobs, -1, tokens[:, 1:, None].long())
    return nll.mean()


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


def build_infer(cfg: Optional[ModelConfig] = None, seed: int = 0,
                attention: Optional[str] = None, device=None):
    """Serving-path build on one device.

    Returns (forward fn -> logits, params, tokens): params from a generator
    seeded with `seed`, a token batch from one seeded with `seed + 1`. The
    forward runs without autograd and can be called repeatedly."""
    cfg, dev, attention = _resolve(cfg, attention, device)
    params = init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
    tokens = torch.randint(0, cfg.vocab, (cfg.batch, cfg.seq_len),
                           generator=torch.Generator(dev).manual_seed(seed + 1),
                           device=dev)

    @torch.no_grad()
    def fwd(p: Params, t: torch.Tensor) -> torch.Tensor:
        return forward(p, t, cfg, attention)

    return fwd, params, tokens
