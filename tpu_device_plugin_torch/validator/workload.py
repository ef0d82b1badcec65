"""Transformer burn-in workload in PyTorch: serving and training.

Port of `tpu_device_plugin/validator/workload.py`: embedding, RMSNorm,
multi-head causal attention, GELU MLP or top-1 switch MoE, unembedding,
cross-entropy, and SGD with momentum, on one device or on a
(pp, dp, sp, ep, tp) mesh (mesh.py).

A second block, the hybrid one (chosen by `ModelConfig.layer_types`),
runs on one device through the same entry points, with RMSNorms with
weights (`w = 1 + g`, g the leaf) and the head tied to the embedding
unless `untied_head`: LFM2's (e.g. LFM2-8B-A1B: gated short-conv and GQA
layers), DeepSeek-V3's (e.g. Moonlight-16B-A3B: multi-head latent
attention, shared experts beside the routed ones, an untied head), and
Granite-4.0-H's (Mamba-2 layers on the chunked scan of ssd.py beside GQA
without positions, a softmax router, muP's multipliers). Each
layer of either block is a token mixer and an MLP of the kinds
`ModelConfig.kinds` names: their functions in `MIXERS` and `FFNS`, their
leaves in `_part_leaves` (`leaf_shapes`).

- Weights keep the JAX layout: `(in, out)` matrices used as `x @ W`, a
  layer's stacked on a leading dim; those of the JAX package load with
  `params_from_jax`.
- Every matmul runs in bfloat16 (weights are cast at the matmul, as the
  JAX forward does); RMSNorm and the served logits are float32; params,
  grads and momentum are float32. The training loss takes the bf16 logits
  and computes the log-softmax in float32 (xent.py: the CUDA kernel pair,
  its plain version on the CPU).
- Attention is `flash` (the CUDA kernels in csrc/, forward and backward;
  their plain versions on the CPU), `ring` (ring_attention.py, over sp) or
  `einsum`.
- The top-1 switch MoE (`_moe`) scatters the tokens its experts keep
  into a buffer and gathers their outputs; `_moe_onehot`, the JAX
  version's one-hot form of it, is its plain version.
- On a mesh, where XLA inserted the collectives from `param_specs`, the
  port calls them itself (distributed.py): `wq`/`wk`/`wv`/`w1`/`w1e` are
  column-sharded over tp (a column block of `wq` is a block of whole
  heads), `wo`/`w2`/`w2e` row-sharded and followed by a sum over tp,
  `embed` sharded on its d columns and gathered, `unembed` row-sharded
  with the logits summed over tp. The residual stream is replicated over
  tp and ep and sharded (dp, sp) like the batch. Each ep rank runs its own
  experts on its block's tokens routed to them, and the MoE outputs are
  summed over ep; routing is global over (dp, sp). The layer stack is cut
  over pp: each stage runs its layers and passes the residual stream to
  the next one (`distributed.pipe_send`); the loss is taken on the last.
  A leaf's gradient is summed over dp and sp, over pp for `embed` and
  `unembed` (used on the first and last stage only), and over ep for `wr`
  (each ep rank sees only its experts' gates). Without a mesh none of
  these calls is made.

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import contextlib
import gc
import math
from collections import Counter
from dataclasses import dataclass, fields
from functools import partial
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import short_conv, ssd, tracing, xent
from .distributed import (all_reduce_grads, enter, exit_, gather, pipe_recv,
                          pipe_send, queue_offsets)
from .mesh import mesh_shape

Params = Dict[str, Any]
Shapes = Dict[str, Tuple[int, ...]]


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
    # Mixture-of-experts: 0 = dense MLP; >0 replaces the MLP with a top-1
    # switch layer of n_experts experts (weights shardable over "ep")
    n_experts: int = 0
    capacity_factor: float = 1.25
    # recompute each layer's activations in the backward instead of
    # keeping them (torch.utils.checkpoint; the JAX version's jax.checkpoint)
    remat: bool = False
    # The hybrid block, chosen by `layer_types`: each layer's token mixer
    # in order, "conv" (a gated short convolution), "attention"
    # ("full_attention" too; GQA, with an RMSNorm on each query and key
    # head and RoPE where rope_theta is set, with neither where not), "mla"
    # (multi-head latent attention) or "mamba" (Mamba-2's mixer); empty for
    # the block above. Its MLPs and experts are SwiGLU, its MoE dropless
    # over the top experts_per_token of sigmoid scores plus a selection
    # bias or of the router's logits (softmax), its RMSNorms have weights,
    # and its head is tied to the embedding unless untied_head. Its
    # numbers, each at its default in the block above: key-value heads (0:
    # n_heads); dense layers before the MoE ones; the experts' width (0:
    # d_ff); experts per token; the experts held here (0: n_experts, which
    # routing always spans); RoPE's theta (0: no RoPE); the norms' eps;
    # latent attention's widths: the latent, each query and key head's
    # dims without and with RoPE, each value head's; the shared experts'
    # width (0: none), run on every token beside the routed ones; the
    # routed weights' scale and the epsilon of their normaliser; the head
    # untied; Mamba-2's widths: its heads, their dim (the inner width is
    # heads x head dim), the state, the groups of B and C, the
    # convolution's taps; the attention scores' scale (0: head dim **
    # -0.5); the router's scores, "sigmoid" or "softmax" (over the chosen
    # logits); the factors on the embedding, on each part's output before
    # the residual add, and the divisor of the logits (muP's).
    layer_types: Tuple[str, ...] = ()
    n_kv_heads: int = 0
    n_dense_layers: int = 0
    expert_d_ff: int = 0
    experts_per_token: int = 1
    experts_held: int = 0
    rope_theta: float = 0.0
    norm_eps: float = 1e-6
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    shared_d_ff: int = 0
    routed_scale: float = 1.0
    router_eps: float = 1e-6
    untied_head: bool = False
    mamba_heads: int = 0
    mamba_head_dim: int = 0
    mamba_state: int = 0
    mamba_groups: int = 0
    mamba_taps: int = 0
    attention_scale: float = 0.0
    router_scores: str = "sigmoid"
    embedding_scale: float = 1.0
    residual_scale: float = 1.0
    logits_scale: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if not self.hybrid:
            moved = [f.name for f in fields(self) if f.name in _HYBRID_NUMBERS
                     and getattr(self, f.name) != f.default]
            if moved:
                raise ValueError(f"{moved} belong to the hybrid block, which "
                                 "layer_types chooses")
            return
        kinds = set(self.layer_types) - {*_OWN_MIXERS, *_ATTENTION}
        if kinds:
            raise ValueError(f"unknown layer types {sorted(kinds)}")
        if "mla" in self.layer_types and (
                min(self.kv_lora_rank, self.qk_nope_head_dim,
                    self.qk_rope_head_dim, self.v_head_dim) <= 0
                or self.qk_rope_head_dim % 2):
            raise ValueError("mla layers need kv_lora_rank, qk_nope_head_dim, "
                             "qk_rope_head_dim (even) and v_head_dim")
        if len(self.layer_types) != self.n_layers:
            raise ValueError(f"{len(self.layer_types)} layer_types for "
                             f"n_layers={self.n_layers}")
        if self.n_heads % (self.n_kv_heads or self.n_heads):
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")
        if self.router_scores not in ("sigmoid", "softmax"):
            raise ValueError(f"router_scores is 'sigmoid' or 'softmax'; got "
                             f"{self.router_scores!r}")
        if self.router_scores == "softmax" and not self.shared_d_ff:
            raise ValueError("the softmax router runs beside shared experts "
                             "(shared_d_ff)")
        mixers = {mixer for mixer, _ in self.kinds(self.n_layers)}
        roped = sorted(mixers & {"qk_norm_attention", "mla"})
        if roped and self.rope_theta <= 0:
            raise ValueError(f"{roped} layers use RoPE and need rope_theta "
                             "> 0")
        if "mamba" in mixers:
            missing = [name for name in _MAMBA_WIDTHS
                       if getattr(self, name) <= 0]
            if missing:
                raise ValueError(f"mamba layers need {missing} > 0")
            if self.mamba_heads % self.mamba_groups:
                raise ValueError(f"mamba_heads={self.mamba_heads} is not a "
                                 f"multiple of mamba_groups="
                                 f"{self.mamba_groups}")

    @property
    def hybrid(self) -> bool:
        """Whether this is the hybrid block (`layer_types` given): its
        norms have weights."""
        return bool(self.layer_types)

    @property
    def tied(self) -> bool:
        """Whether the head is tied to the embedding (logits = h embed^T):
        the hybrid block's unless `untied_head`; the block above has its
        own `unembed`."""
        return self.hybrid and not self.untied_head

    def kinds(self, n: int) -> List[Tuple[str, str]]:
        """(token mixer, MLP) of each of `n` layers, keys of `MIXERS` and
        `FFNS`: above, "attention" and "mlp", or "switch" with n_experts;
        in the hybrid block "conv", "mla" or "mamba" by `layer_types`, and
        for its attention layers "qk_norm_attention" where rope_theta is
        set and "attention" where not; "swiglu", or past n_dense_layers with
        n_experts "dropless", "shared_dropless" with shared_d_ff,
        "softmax_shared_dropless" with the softmax router."""
        if not self.hybrid:
            return [("attention", "switch" if self.n_experts else "mlp")] * n
        moe = "shared_dropless" if self.shared_d_ff else "dropless"
        if self.router_scores == "softmax":
            moe = "softmax_shared_dropless"
        attention = "qk_norm_attention" if self.rope_theta > 0 else "attention"
        types = self.layer_types
        return [(types[i] if types[i] in _OWN_MIXERS else attention,
                 moe if self.n_experts and i >= self.n_dense_layers
                 else "swiglu") for i in range(n)]


_ATTENTION = ("attention", "full_attention")
# layer types that name their mixer's kind
_OWN_MIXERS = ("conv", "mla", "mamba")
_MAMBA_WIDTHS = ("mamba_heads", "mamba_head_dim", "mamba_state",
                 "mamba_groups", "mamba_taps")
_HYBRID_NUMBERS = ("n_kv_heads", "n_dense_layers", "expert_d_ff",
                   "experts_per_token", "experts_held", "rope_theta",
                   "norm_eps", "kv_lora_rank", "qk_nope_head_dim",
                   "qk_rope_head_dim", "v_head_dim", "shared_d_ff",
                   "routed_scale", "router_eps", "untied_head",
                   *_MAMBA_WIDTHS, "attention_scale", "router_scores",
                   "embedding_scale", "residual_scale", "logits_scale")
CONV_TAPS = 3   # the short convolution's taps (LFM2's conv_L_cache)
# the latent's RMSNorm eps in latent attention: DeepSeek-V3's
# kv_a_layernorm takes its norm's default, not the block's rms_norm_eps
LATENT_EPS = 1e-6
# Mamba-2's A_log and dt_bias are stored as offsets from these, as the norm
# weights are stored as offsets from 1 (and D too), so that a draw of
# N(0, 1) times a scale makes them: a = -exp(MAMBA_A_LOG + A_log), -4 at
# the offset 0, in Mamba's range -1 .. -16; softplus(MAMBA_DT_BIAS) = 0.01,
# in the range 0.001 .. 0.1 of its time_step_min / max
MAMBA_A_LOG = math.log(4.0)
MAMBA_DT_BIAS = math.log(math.expm1(0.01))
# norm weights (and Mamba-2's offsets above) are drawn as 0 here; the bias
# only selects experts
_ZERO_INIT = ("q_norm", "k_norm", "kv_norm", "op_norm", "ffn_norm",
              "final_norm", "moe_bias", "gate_norm", "A_log", "dt_bias", "D")


def leaf_shapes(cfg: ModelConfig) -> Shapes:
    """{dotted leaf name: shape}, in the order `init_params` draws them:
    the block's leaves before the layers (`_block_leaves`); under `layers.`
    each kind's (`_part_leaves`), stacked on the layers of that kind, then
    the block's of every layer; the block's leaves after the layers."""
    first, every, last = _block_leaves(cfg)
    n = Counter(kind for pair in cfg.kinds(cfg.n_layers) for kind in pair)
    shapes = dict(first)
    for kind, leaves in _part_leaves(cfg).items():
        if n[kind]:
            shapes.update({f"layers.{key}": (n[kind], *shape)
                           for key, shape in leaves.items()})
    shapes.update({f"layers.{key}": (cfg.n_layers, *shape)
                   for key, shape in every.items()})
    shapes.update(last)
    return shapes


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
    from `generator` (which must live on `device`) in `leaf_shapes` order;
    the hybrid block's norm offsets and expert bias are 0."""
    dev = resolve_device(device)
    scale = cfg.d_model ** -0.5
    params: Params = {}
    for name, shape in leaf_shapes(cfg).items():
        *parents, key = name.split(".")
        if key in _ZERO_INIT:
            leaf = torch.zeros(shape, device=dev)
        else:
            leaf = torch.randn(shape, generator=generator,
                               dtype=torch.float32, device=dev) * scale
        (params.setdefault("layers", {}) if parents else params)[key] = leaf
    return params


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


class _Axes:
    """This rank's place on the mesh: each axis's process group, size and
    index. pp and ep, which a mesh holds only when larger than 1, have
    size 1, index 0 and no group where it lacks them; `stages` are the
    global ranks of this rank's pp group, first stage first."""

    def __init__(self, mesh):
        names = mesh.mesh_dim_names
        self.group = {name: mesh.get_group(name) for name in names}
        self.size = {"pp": 1, "ep": 1, **mesh_shape(mesh)}
        self.index = {"pp": 0, "ep": 0,
                      **{name: mesh.get_local_rank(name) for name in names}}
        self.stages = (dist.get_process_group_ranks(self.group["pp"])
                       if "pp" in names else [])

    def last_stage(self) -> bool:
        return self.index["pp"] == self.size["pp"] - 1

    def routing(self, axis: str):
        """(group, index) on a batch axis for `queue_offsets`, or None."""
        if self.size[axis] == 1:
            return None
        return self.group[axis], self.index[axis]


def _one_device(cfg: ModelConfig) -> None:
    if cfg.hybrid:
        raise ValueError(
            "the hybrid block (conv and GQA layers, SwiGLU, dropless top-k "
            "MoE, tied embeddings) runs on one device: its leaves have no "
            "mesh sharding")


def _axes(mesh, cfg: ModelConfig) -> Optional[_Axes]:
    if mesh is None:
        return None
    _one_device(cfg)
    return _Axes(mesh)


def _row_sharded(x: torch.Tensor, w: torch.Tensor,
                 ax: Optional[_Axes]) -> torch.Tensor:
    """x @ w in bf16 for a row-sharded w: the partial products summed over
    tp. Over tp > 1 each partial is taken in f32 (from the bf16 operands)
    and rounded to bf16 once, after the sum, as the unsharded product is
    rounded once; rounding each partial first moved the loss by 1.3e-3 at
    test_torch_sharded.py's configuration. At one rank the bf16 product
    itself is passed on."""
    if ax is None:
        return x @ _bf16(w)
    if ax.size["tp"] == 1:
        return exit_(x @ _bf16(w), ax.group["tp"])
    partial = x.float() @ _bf16(w).float()
    return exit_(partial, ax.group["tp"]).to(torch.bfloat16)


def _rotary(s: int, dh: int, theta: float, device) -> Tuple[torch.Tensor,
                                                            torch.Tensor]:
    """RoPE's f32 cos and sin, (s, 1, dh): position p turns the pair
    (i, i + dh/2) by p x theta ** (-2i / dh) (non-interleaved halves)."""
    inv = theta ** -(torch.arange(0, dh, 2, device=device,
                                  dtype=torch.float32) / dh)
    angle = torch.arange(s, device=device, dtype=torch.float32)[:, None] * inv
    angle = torch.cat([angle, angle], -1)[:, None]
    return angle.cos(), angle.sin()


def _head_norm_rope(t: torch.Tensor, offset: torch.Tensor, rope,
                    eps: float) -> torch.Tensor:
    """(b, s, heads, dh) bf16 through RMSNorm over each head (weight
    1 + offset), then RoPE by `rope` (cos, sin), in f32, rounded to bf16
    once."""
    y = t.float()
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
    y = y * (1 + offset)
    cos, sin = rope
    y1, y2 = y.chunk(2, -1)
    y = y * cos + torch.cat([-y2, y1], -1) * sin
    return y.to(t.dtype)


def _attention(x: torch.Tensor, layer: Params, cfg: ModelConfig,
               attention: str = "einsum", ax: Optional[_Axes] = None,
               qk_norm: bool = False) -> torch.Tensor:
    """Causal attention; with `qk_norm`, `_head_norm_rope` on q and k."""
    b, s, _ = x.shape
    dh = cfg.d_model // cfg.n_heads
    h = layer["wq"].shape[-1] // dh   # this rank's heads
    kv = layer["wk"].shape[-1] // dh
    if ax is not None:
        x = enter(x, ax.group["tp"])
    q = (x @ _bf16(layer["wq"])).reshape(b, s, h, dh)
    k = (x @ _bf16(layer["wk"])).reshape(b, s, kv, dh)
    v = (x @ _bf16(layer["wv"])).reshape(b, s, kv, dh)
    if qk_norm:
        rope = _rotary(s, dh, cfg.rope_theta, x.device)
        q = _head_norm_rope(q, layer["q_norm"], rope, cfg.norm_eps)
        k = _head_norm_rope(k, layer["k_norm"], rope, cfg.norm_eps)
    if kv != h:
        # grouped-query attention: query head i reads key-value head
        # i // (h / kv); the copy's backward sums each group
        k = k[:, :, :, None].expand(b, s, kv, h // kv, dh).reshape(b, s, h, dh)
        v = v[:, :, :, None].expand(b, s, kv, h // kv, dh).reshape(b, s, h, dh)
    out = _attend(q, k, v, cfg.attention_scale or dh ** -0.5, attention, ax)
    return _row_sharded(out, layer["wo"], ax)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            attention: str, ax: Optional[_Axes]) -> torch.Tensor:
    """Causal attention of q and k (b, s, h, head dim) over v (b, s, h,
    v's head dim), scores scaled by `scale`: (b, s, h x v's head dim)."""
    b, s, h, _ = q.shape
    if attention == "ring":
        from .ring_attention import (ProcessGroupRing, ThreadRing,
                                     ring_attention, ring_flash_attention)
        ring = (ProcessGroupRing(ax.group["sp"]) if ax is not None
                else ThreadRing(1).member(0))
        # the kernels on the card, the einsum ring on CPU tensors, as the
        # JAX workload runs ring flash on the chip and the einsum ring
        # under interpret
        run = ring_flash_attention if q.is_cuda else ring_attention
        o = run(_fold_heads(q).contiguous(), _fold_heads(k).contiguous(),
                _fold_heads(v).contiguous(), scale, ring)
        return _unfold_heads(o, b, h).reshape(b, s, -1)
    if attention == "flash":
        from .flash_attention import flash_attention
        o = flash_attention(_fold_heads(q).contiguous(),
                            _fold_heads(k).contiguous(),
                            _fold_heads(v).contiguous(), scale, True)
        return _unfold_heads(o, b, h).reshape(b, s, -1)
    # einsum; sequence parallelism: queries stay sharded, keys and values
    # are gathered over sp; the causal mask is global, so it is offset by
    # this shard's first position
    offset = 0
    if ax is not None and ax.size["sp"] > 1:
        k = gather(k, 1, ax.group["sp"], sum_grads=True)
        v = gather(v, 1, ax.group["sp"], sum_grads=True)
        offset = ax.index["sp"] * s
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = torch.ones((s, k.shape[1]), dtype=torch.bool,
                      device=q.device).tril(offset)
    scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, -1)


def _rotary_pairs(s: int, r: int, theta: float, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE's f32 cos and sin, (s, 1, r/2), for rotating adjacent pairs:
    position p turns the pair (2i, 2i + 1) by p x theta ** (-2i / r)."""
    inv = theta ** -(torch.arange(0, r, 2, device=device,
                                  dtype=torch.float32) / r)
    angle = torch.arange(s, device=device, dtype=torch.float32)[:, None] * inv
    return angle.cos()[:, None], angle.sin()[:, None]


def _rope_pairs(t: torch.Tensor, rope) -> torch.Tensor:
    """(b, s, heads, r) bf16 turned by RoPE (`_rotary_pairs`' cos, sin) over
    adjacent pairs, in f32, rounded to bf16 once. DeepSeek-V3's published
    form (rope_interleave) first moves the even dims before the odd ones
    and then turns the halves; the move is the same for q and k, so q . k
    is the same, and the pairs are turned in place here."""
    cos, sin = rope
    y = t.float().unflatten(-1, (-1, 2))
    y0, y1 = y[..., 0], y[..., 1]
    y = torch.stack([y0 * cos - y1 * sin, y1 * cos + y0 * sin], -1)
    return y.flatten(-2).to(t.dtype)


def _mla(x: torch.Tensor, layer: Params, cfg: ModelConfig,
         attention: str) -> torch.Tensor:
    """Multi-head latent attention (DeepSeek-V3's, without a query LoRA) on
    x (b, s, d) bf16, under the span `mla.project` up to the attention:

    - q = x @ q_proj: per head qk_nope_head_dim dims without RoPE and
      qk_rope_head_dim with;
    - x @ kv_a: the latent (kv_lora_rank) and one RoPE key shared by every
      head; the latent through an RMSNorm (weight 1 + kv_norm, LATENT_EPS),
      then @ kv_b: per head a key without RoPE and a value (v_head_dim);
    - RoPE on q's rope dims and on the shared key (`_rope_pairs`); each
      head's key is [its own, the shared one], whose gradient is so summed
      over the heads;
    - causal attention scaled by the query/key head dim ** -0.5: flash
      takes K1-K3 at (qk head dim, v_head_dim), nothing padded (counter
      `mla.flash_rows`, b s heads a layer); then @ o_proj."""
    if attention == "ring":
        raise ValueError("latent attention runs flash or einsum attention")
    b, s, _ = x.shape
    h, nope, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    lat = cfg.kv_lora_rank
    with tracing.span("mla.project"):
        q = (x @ _bf16(layer["q_proj"])).view(b, s, h, nope + r)
        kv = x @ _bf16(layer["kv_a"])
        latent = _rms_norm(kv[..., :lat], LATENT_EPS, layer["kv_norm"])
        kvb = (latent @ _bf16(layer["kv_b"])).view(b, s, h, -1)
        rope = _rotary_pairs(s, r, cfg.rope_theta, x.device)
        q = torch.cat([q[..., :nope], _rope_pairs(q[..., nope:], rope)], -1)
        shared = _rope_pairs(kv[..., None, lat:], rope)
        k = torch.cat([kvb[..., :nope], shared.expand(b, s, h, r)], -1)
        v = kvb[..., nope:]
    out = _attend(q, k, v, (nope + r) ** -0.5, attention, None)
    if attention == "flash":
        tracing.count("mla.flash_rows", b * s * h)
    return out @ _bf16(layer["o_proj"])


def _mlp(x: torch.Tensor, layer: Params,
         ax: Optional[_Axes] = None) -> torch.Tensor:
    if ax is not None:
        x = enter(x, ax.group["tp"])
    # jax.nn.gelu defaults to the tanh approximation
    hidden = F.gelu(x @ _bf16(layer["w1"]), approximate="tanh")
    return _row_sharded(hidden, layer["w2"], ax)


def _swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """The hybrid block's dense MLP, w2(silu(w1 x) * w3 x), in bf16."""
    hidden = F.silu(x @ _bf16(w1)) * (x @ _bf16(w3))
    return hidden @ _bf16(w2)


def _short_conv(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """LFM2's gated short convolution on x (b, s, d) bf16:
    B, C, h = chunk(x @ conv_in, 3); out = (C * conv(B * h)) @ conv_out,
    the convolution depthwise and causal over `conv_w`'s taps
    (short_conv.py: the CUDA kernel pair, its plain version on the CPU)."""
    gated = short_conv.gated_conv(x @ _bf16(layer["conv_in"]),
                                  layer["conv_w"])
    return gated @ _bf16(layer["conv_out"])


def _mamba(x: torch.Tensor, layer: Params, cfg: ModelConfig) -> torch.Tensor:
    """Mamba-2's mixer (Granite-4.0-H's) on x (b, s, d) bf16:

    - z, xBC, dt = split(x @ in_proj), z of the inner width, xBC of inner +
      2 groups x state, dt one per head;
    - xBC through the causal depthwise convolution of `conv_w`'s taps with
      the bias `conv_b`, then SiLU (short_conv.conv_silu: C1's ungated
      kernels on the card, reading xBC in place in the projection's rows
      where their width is a multiple of 8; span `mamba.conv`); then split
      into x, B and C;
    - dt = softplus(dt + MAMBA_DT_BIAS + dt_bias) and a = -exp(MAMBA_A_LOG
      + A_log), in f32; the scan (ssd.py: S1 on the card, counter
      `mamba.scan_rows`, b s heads; span `mamba.scan`) with D = 1 + D's
      leaf;
    - the RMSNorm of y silu(z) over the inner width (Mamba-2's gated norm,
      one group) in f32, its weight 1 + gate_norm, rounded to bf16 once;
      then @ out_proj."""
    b, s, _ = x.shape
    heads, p = cfg.mamba_heads, cfg.mamba_head_dim
    g, n = cfg.mamba_groups, cfg.mamba_state
    inner = heads * p
    z, xbc, dt = (x @ _bf16(layer["in_proj"])).split(
        [inner, inner + 2 * g * n, heads], -1)
    if xbc.stride(1) % 8:
        # C1 reads rows 16 bytes at a time: a projection whose width is not
        # a multiple of 8 (not Granite's 16768) is copied dense first
        xbc = xbc.contiguous()
    with tracing.span("mamba.conv"):
        xbc = short_conv.conv_silu(xbc, layer["conv_w"], layer["conv_b"])
    xs, B, C = xbc.split([inner, g * n, g * n], -1)
    delta = F.softplus(dt.float() + (MAMBA_DT_BIAS + layer["dt_bias"]))
    a = -torch.exp(MAMBA_A_LOG + layer["A_log"])
    with tracing.span("mamba.scan"):
        y = ssd.ssd(xs.view(b, s, heads, p), delta, a, B.view(b, s, g, n),
                    C.view(b, s, g, n), 1 + layer["D"])
    if y.is_cuda:
        tracing.count("mamba.scan_rows", b * s * heads)
    gated = y.view(b, s, inner).float() * F.silu(z.float())
    y = _rms_norm(gated, cfg.norm_eps, layer["gate_norm"]).to(y.dtype)
    return y @ _bf16(layer["out_proj"])


def _capacity(tokens: int, n_experts: int, factor: float) -> int:
    """Per-expert capacity over `tokens` tokens, padded to a multiple of 8."""
    return min(tokens, max(8, math.ceil(
        math.ceil(tokens * factor / n_experts) / 8) * 8))


def _route(xt: torch.Tensor, wr: torch.Tensor):
    """Top-1 routing of tokens xt (t, d) bf16: each token's argmax expert
    (the first on ties, as jnp.argmax) and its gate, of the f32 softmax
    over the router logits. The logits are the f32 products of the bf16
    operands, not rounded to bf16: jit folds the JAX version's
    `(xt @ bf16(wr)).astype(f32)` into one dot with f32 output, so its
    step routes on those (a bf16 rounding there put two logits of one
    token a bf16 ulp apart and flipped its expert)."""
    gates = torch.softmax(xt.float() @ _bf16(wr).float(), dim=-1)
    top1 = gates.argmax(dim=-1)
    return gates.gather(-1, top1[:, None])[:, 0], top1


def _one_hot(index: torch.Tensor, n: int) -> torch.Tensor:
    """int32 one-hot rows of `index` (F.one_hot's int64, without its
    range check, which waits for the card)."""
    return (index[:, None] == torch.arange(n, device=index.device)).int()


def _running_count(flags: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum along the last dim, in int32. The scan runs
    along the innermost dim of a contiguous copy: over an outer dim, with
    few columns, torch's scan kernel has almost no parallelism (on an
    H100 the queue places at the mfu width took 3 ms per layer so)."""
    return flags.contiguous().cumsum(-1, dtype=torch.int32)


def _experts(expert_in: torch.Tensor, layer: Params,
             ax: Optional[_Axes]) -> torch.Tensor:
    """The experts' tanh-GELU MLPs on their (E, capacity, d) inputs, as
    batched bf16 matmuls; over tp, w2e's partials are summed in f32 and
    rounded once (`_row_sharded`)."""
    hidden = F.gelu(expert_in @ _bf16(layer["w1e"]), approximate="tanh")
    return _row_sharded(hidden, layer["w2e"], ax)


def _moe(x: torch.Tensor, layer: Params, cfg: ModelConfig,
         ax: Optional[_Axes] = None) -> torch.Tensor:
    """Top-1 switch MoE on x (b, s, d) bf16.

    The capacity and each token's place in its expert's queue are those of
    the global batch (b-major), as in the JAX version, which routes the
    whole batch in one program: on a mesh the per-row counts are gathered
    over dp and sp (`distributed.queue_offsets`). A token past its
    expert's capacity is dropped (its output is 0). Each rank runs its ep
    shard of the experts on its block's kept tokens routed there: they are
    scattered into an (E_local, slots, d) buffer in token order, the
    expert outputs gathered back and scaled by the gate, rounded to bf16
    first (bf16(gate) x output in f32, rounded once: the value of the JAX
    version's one-hot combine, whose every element is one such product).
    The outputs are summed over ep, where exactly one rank holds each
    token's term."""
    b, s, d = x.shape
    t = b * s
    dp, sp, ep = ((1, 1, 1) if ax is None else
                  (ax.size["dp"], ax.size["sp"], ax.size["ep"]))
    if ep > 1:
        # the router and the experts see only this rank's experts' tokens
        x = enter(x, ax.group["ep"])
    xt = x.reshape(t, d)
    gate, top1 = _route(xt, layer["wr"])
    cap = _capacity(t * dp * sp, cfg.n_experts, cfg.capacity_factor)
    onehot = _one_hot(top1, cfg.n_experts).view(b, s, -1)
    offsets = queue_offsets(
        onehot.sum(1, dtype=torch.int32), *(None, None) if ax is None else
        (ax.routing("dp"), ax.routing("sp")))
    place = _running_count(onehot.transpose(1, 2)).transpose(1, 2)
    place = (place + offsets[:, None]).reshape(t, -1)
    kept = place.gather(1, top1[:, None])[:, 0] <= cap
    if tracing.counting():
        tracing.count("moe.routed", t)
        tracing.count("moe.dropped", (~kept).sum())

    n_local = layer["w1e"].shape[0]
    local = top1 - (0 if ax is None else ax.index["ep"]) * n_local
    mine = kept & (local >= 0) & (local < n_local)
    local = local.clamp(0, n_local - 1)
    # a slot per token of this rank kept by each local expert, in token
    # order; a buffer row past the last slot takes every other token
    slots = min(cap, t)
    mine_hot = _one_hot(local, n_local) * mine[:, None]
    slot = _running_count(mine_hot.t()).t()
    slot = slot.gather(1, local[:, None])[:, 0] - 1
    row = torch.where(mine, local * slots + slot, n_local * slots)
    xe = x if ax is None else enter(x, ax.group["tp"])
    buf = xe.new_zeros(n_local * slots + 1, d).index_copy(
        0, row, xe.reshape(t, d))
    expert_out = _experts(buf[:-1].view(n_local, slots, d), layer, ax)
    picked = expert_out.reshape(-1, d).index_select(
        0, row.clamp(max=n_local * slots - 1))
    scale = torch.where(mine, _bf16(gate), 0).float()
    out = (scale[:, None] * picked.float()).to(torch.bfloat16)
    if ep > 1:
        out = exit_(out, ax.group["ep"])
    return out.view(b, s, d)


def _moe_onehot(x: torch.Tensor, layer: Params,
                cfg: ModelConfig) -> torch.Tensor:
    """`_moe`'s plain version on one device: the JAX version's one-hot
    dispatch and combine einsums over (t, E, capacity) tensors, with the
    same routing and experts. Its cost grows as t^2 d; it serves only to
    check `_moe`."""
    b, s, d = x.shape
    t, e = b * s, cfg.n_experts
    cap = _capacity(t, e, cfg.capacity_factor)
    xt = x.reshape(t, d)
    gate, top1 = _route(xt, layer["wr"])
    onehot = F.one_hot(top1, e).float()
    pos = onehot.cumsum(0) * onehot                        # 1-based
    within = (pos > 0) & (pos <= cap)
    dispatch = (F.one_hot((pos - 1).long().clamp(0, cap - 1), cap).float()
                * within[..., None])                       # (t, e, cap)
    combine = dispatch * gate[:, None, None]
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(torch.bfloat16), xt)
    expert_out = _experts(expert_in, layer, None)
    out = torch.einsum("tec,ecd->td", combine.to(torch.bfloat16), expert_out)
    return out.view(b, s, d)


def _route_topk(xt: torch.Tensor, wr: torch.Tensor,
                bias: Optional[torch.Tensor],
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens xt (t, d) bf16 over all n_experts, on the
    f32 router logits of the bf16 operands (as `_route`), by the router
    that the FFN kind gives `_moe_dropless`, which passes:

    - the sigmoid router's selection bias (e,): scores s = sigmoid(logits);
      the experts_per_token largest s + bias, the bias selecting only (no
      gradient reaches it); their weights the chosen s, divided by their
      sum + router_eps
      (norm_topk_prob: LFM2's 1e-6, DeepSeek-V3's 1e-20). One group of
      experts: DeepSeek-V3's group-limited choice with n_group = topk_group
      = 1 keeps every expert.
    - None for the softmax router: the experts_per_token largest logits,
      weighted by the softmax over those alone (Granite's top-k gating).

    Then times routed_scale where it is not 1 (routed_scaling_factor).
    Returns (weights (t, k) f32, experts (t, k))."""
    logits = xt.float() @ _bf16(wr).float()
    if bias is None:
        top = logits.topk(cfg.experts_per_token, -1)
        weights, chosen = torch.softmax(top.values, -1), top.indices
    else:
        scores = torch.sigmoid(logits)
        chosen = (scores.detach() + bias.detach()).topk(
            cfg.experts_per_token, -1).indices
        weights = scores.gather(1, chosen)
        weights = weights / (weights.sum(-1, keepdim=True) + cfg.router_eps)
    if cfg.routed_scale != 1:
        weights = weights * cfg.routed_scale
    return weights, chosen


def _dispatch_plan(chosen: torch.Tensor, first: int, held: int):
    """Where each (token, expert) pair of `chosen` (t, k) goes among the
    experts [first, first + held) held here, all on the device: the pairs
    sorted by held expert (stable, so in token order within one), the
    others after them. Returns (ends, order, pos, mine): `ends` (held,)
    int32, each held expert's last sorted row + 1; `order` (t k,) the pair
    (token x k + j) of each sorted row; `pos` (t, k) each pair's sorted
    row, `order`'s inverse; `mine` (t, k) whether its expert is held."""
    t, k = chosen.shape
    local = chosen.reshape(-1) - first
    mine = (local >= 0) & (local < held)
    key, order = torch.where(mine, local, held).sort(stable=True)
    ends = torch.searchsorted(key, torch.arange(held, device=key.device),
                              right=True)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(t * k, device=key.device))
    return ends.int(), order, pos.view(t, k), mine.view(t, k)


class _Dispatch(torch.autograd.Function):
    """xt (t, d)'s rows in sorted-pair order, (t k, d): row r is the token
    of pair order[r]. Backward: each token's gradient is the sum over its
    held pairs of their rows' gradients, gathered by `pos` and summed in
    f32 (rounded once), with no atomic adds; the rows of pairs not held
    (past the last offset, undefined) are masked out."""

    @staticmethod
    def forward(ctx, xt, order, pos, mine):
        ctx.save_for_backward(pos, mine)
        return xt.index_select(0, order // pos.shape[1])

    @staticmethod
    def backward(ctx, grad):
        pos, mine = ctx.saved_tensors
        rows = grad.index_select(0, pos.reshape(-1)).view(*pos.shape, -1)
        return torch.where(mine[..., None], rows, 0).sum(1), None, None, None


class _Permuted(torch.autograd.Function):
    """x's rows in the order of the permutation `index`; its backward is
    the gather by the inverse permutation (no atomic adds)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        inverse, = ctx.saved_tensors
        return grad.index_select(0, inverse), None, None


def _held_experts(xt: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                  w2: torch.Tensor, weights: torch.Tensor,
                  ends: torch.Tensor, order: torch.Tensor, pos: torch.Tensor,
                  mine: torch.Tensor) -> torch.Tensor:
    """The held SwiGLU experts' weighted sum for each token of xt (t, d):
    xt's rows gathered into expert order, the experts as grouped bf16
    products over `ends` (torch._grouped_mm), then for each token its
    pairs' outputs times their bf16 weights (each product in bf16), summed
    in f32 and rounded once. (A batched product for the sum ran its
    backward at (t, 1, d) x (t, d, k) on the card 8 times slower.)
    The buffer has a row for every pair, which no routing can overflow.
    The grouped products stop at the held pairs, but the gathers and the
    SwiGLU's elementwise passes run over the whole buffer, so over rows
    past the held pairs, whose values are undefined; `where` on `mine`
    drops those rows from the result and from the token gradients."""
    t, d = xt.shape
    with tracing.span("moe.dispatch"):
        xs = _Dispatch.apply(xt, order, pos, mine)
    with tracing.span("moe.experts"):
        hidden = (F.silu(torch._grouped_mm(xs, _bf16(w1), offs=ends))
                  * torch._grouped_mm(xs, _bf16(w3), offs=ends))
        ys = torch._grouped_mm(hidden, _bf16(w2), offs=ends)
    with tracing.span("moe.combine"):
        picked = _Permuted.apply(ys, pos.reshape(-1), order)
        picked = torch.where(mine[..., None], picked.view(*pos.shape, d), 0)
        return (picked * _bf16(weights)[..., None]).sum(1)


def _moe_dropless(x: torch.Tensor, layer: Params, cfg: ModelConfig,
                  first: int = 0, router: str = "sigmoid") -> torch.Tensor:
    """The hybrid block's dropless top-k MoE on x (b, s, d) bf16, on one
    device holding experts [first, first + w1e.shape[0]): every
    token routed over all n_experts by `router` (`_route_topk`; the
    sigmoid router with the selection bias `moe_bias`), the pairs to the
    experts held computed (`_held_experts`), none dropped; what the
    experts held elsewhere would add is not part of the result. Nothing
    is read back to the host. The experts' products are recomputed in the
    backward (checkpoint), the bf16 casts of the f32 expert weights too:
    the buffers are sized for any routing, four times the expected rows
    at top-4 of 32 over 8 held. Under `cfg.remat` the whole layer is
    recomputed already, so the experts are not checkpointed again (that
    would run their products a third time)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    bias = layer["moe_bias"] if router == "sigmoid" else None
    with tracing.span("moe.route"):
        weights, chosen = _route_topk(xt, layer["wr"], bias, cfg)
    with tracing.span("moe.dispatch"):
        plan = _dispatch_plan(chosen, first, layer["w1e"].shape[0])
    if tracing.counting():
        ends = plan[0]
        tracing.count("moe.routed", chosen.numel())
        tracing.count("moe.held", ends[-1])
        tracing.count("moe.dropped", 0)
        tracing.count("moe.max_rows", torch.diff(ends, prepend=ends[:1] * 0)
                      .max())
    args = (xt, layer["w1e"], layer["w3e"], layer["w2e"], weights, *plan)
    out = (_held_experts(*args) if cfg.remat else
           checkpoint(_held_experts, *args, use_reentrant=False,
                      preserve_rng_state=False))
    return out.view(b, s, d)


def _moe_shared(x: torch.Tensor, layer: Params, cfg: ModelConfig,
                router: str = "sigmoid") -> torch.Tensor:
    """DeepSeek-V3's MoE on x (b, s, d) bf16: the dropless routed experts
    held here (`_moe_dropless`, by `router`) plus the shared experts, one
    SwiGLU of width shared_d_ff on every token (span `moe.shared`), added
    in bf16 as the published layer adds them. Every chip of an expert-parallel
    deployment computes the shared experts alike, for its own tokens."""
    routed = _moe_dropless(x, layer, cfg, router=router)
    with tracing.span("moe.shared"):
        shared = _swiglu(x, layer["ws1"], layer["ws3"], layer["ws2"])
    return routed + shared


def _rms_norm(x: torch.Tensor, eps: float = 1e-6,
              offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSNorm of x over its last dim, with the weight 1 + offset where an
    offset (the leaf) is given, rounded once to x's dtype."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    # bf16 x times an f32 rsqrt promotes to f32, as in the JAX version
    y = x * torch.rsqrt(var + eps)
    if offset is not None:
        y = y * (1 + offset)
    return y.to(x.dtype)


def _block_leaves(cfg: ModelConfig) -> Tuple[Shapes, Shapes, Shapes]:
    """The block's own leaves, no part's: before the layers (`embed`; and
    `unembed` unless `cfg.tied`), of every layer (the hybrid block's norm
    offsets, `_block_norm`), after them (`final_norm`)."""
    d, v = cfg.d_model, cfg.vocab
    first = {"embed": (v, d)} if cfg.tied else {"embed": (v, d),
                                                "unembed": (d, v)}
    if cfg.hybrid:
        return (first, {"op_norm": (d,), "ffn_norm": (d,)},
                {"final_norm": (d,)})
    return first, {}, {}


def _block_norm(x: torch.Tensor, leaves: Params, key: str,
                cfg: ModelConfig) -> torch.Tensor:
    """The block's RMSNorm at cfg's eps: gain-less in the block above,
    weighted by the offset leaf `key` in the hybrid block."""
    return _rms_norm(x, cfg.norm_eps, leaves[key] if cfg.hybrid else None)


def _part_leaves(cfg: ModelConfig) -> Dict[str, Shapes]:
    """Each kind of `MIXERS` and `FFNS` with its leaves, {name: one layer's
    shape}, in the order `leaf_shapes` stacks them, and so `init_params`
    draws them: the mixers, the MoE kinds, the dense ones."""
    d, ff, e, h = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_heads
    dh = d // h
    kv = (cfg.n_kv_heads or h) * dh
    fe, held = cfg.expert_d_ff or ff, cfg.experts_held or e
    fs, lat = cfg.shared_d_ff, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    mh = cfg.mamba_heads
    inner = mh * cfg.mamba_head_dim
    xbc = inner + 2 * cfg.mamba_groups * cfg.mamba_state
    attention = {"wq": (d, d), "wk": (d, kv), "wv": (d, kv), "wo": (d, d)}
    w1e, w2e = (held, d, fe), (held, fe, d)
    routed = {"wr": (d, e), "w1e": w1e, "w3e": w1e, "w2e": w2e}
    dropless = {**routed, "moe_bias": (e,)}
    shared = {"ws1": (d, fs), "ws3": (d, fs), "ws2": (fs, d)}
    return {
        "attention": attention,
        "qk_norm_attention": {**attention, "q_norm": (dh,), "k_norm": (dh,)},
        "conv": {"conv_in": (d, 3 * d), "conv_w": (CONV_TAPS, d),
                 "conv_out": (d, d)},
        "mla": {"q_proj": (d, h * (nope + rope)), "kv_a": (d, lat + rope),
                "kv_norm": (lat,), "kv_b": (lat, h * (nope + dv)),
                "o_proj": (h * dv, d)},
        "mamba": {"in_proj": (d, inner + xbc + mh),
                  "conv_w": (cfg.mamba_taps, xbc), "conv_b": (xbc,),
                  "dt_bias": (mh,), "A_log": (mh,), "D": (mh,),
                  "gate_norm": (inner,), "out_proj": (inner, d)},
        "switch": {"wr": (d, e), "w1e": w1e, "w2e": w2e},
        "dropless": dropless,
        "shared_dropless": {**dropless, **shared},
        "softmax_shared_dropless": {**routed, **shared},
        "mlp": {"w1": (d, ff), "w2": (ff, d)},
        "swiglu": {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)},
    }


class _Part(NamedTuple):
    """A kind of token mixer or MLP (`ModelConfig.kinds`; its leaves in
    `_part_leaves`): its span (tracing.py) and its output
    run(h, layer, cfg, attention, ax) for the normed stream h."""
    span: str
    run: Callable[..., torch.Tensor]


MIXERS: Dict[str, _Part] = {
    "attention": _Part("workload.attention", _attention),
    "qk_norm_attention": _Part("workload.attention",
                               partial(_attention, qk_norm=True)),
    "conv": _Part("workload.conv", lambda h, layer, *_: _short_conv(h, layer)),
    "mla": _Part("workload.attention",
                 lambda h, layer, cfg, attention, _: _mla(h, layer, cfg,
                                                          attention)),
    "mamba": _Part("workload.mamba",
                   lambda h, layer, cfg, *_: _mamba(h, layer, cfg)),
}
FFNS: Dict[str, _Part] = {
    "switch": _Part("workload.ffn",
                    lambda h, layer, cfg, _, ax: _moe(h, layer, cfg, ax)),
    "dropless": _Part("workload.ffn",
                      lambda h, layer, cfg, *_: _moe_dropless(h, layer, cfg)),
    "shared_dropless": _Part("workload.ffn",
                             lambda h, layer, cfg, *_: _moe_shared(h, layer,
                                                                   cfg)),
    "softmax_shared_dropless": _Part("workload.ffn",
                                     lambda h, layer, cfg, *_: _moe_shared(
                                         h, layer, cfg, router="softmax")),
    "mlp": _Part("workload.ffn", lambda h, layer, _, __, ax: _mlp(h, layer, ax)),
    "swiglu": _Part("workload.ffn", lambda h, layer, *_: _swiglu(
        h, layer["w1"], layer["w3"], layer["w2"])),
}


def _layer_body(x: torch.Tensor, layer: Params, cfg: ModelConfig,
                attention: str, ax: Optional[_Axes],
                kind: Tuple[str, str]) -> torch.Tensor:
    """One layer: its token mixer, then its MLP, each on the normed stream
    and added to it (times residual_scale where it is not 1), under its
    part's span. `kind` is the layer's (mixer, MLP) of `cfg.kinds`."""
    mixer, ffn = kind
    for part, norm in ((MIXERS[mixer], "op_norm"), (FFNS[ffn], "ffn_norm")):
        with tracing.span(part.span):
            h = _block_norm(x, layer, norm, cfg)
            out = part.run(h, layer, cfg, attention, ax)
            if cfg.residual_scale != 1:
                out = out * cfg.residual_scale
            y = x + out
            x = tracing.backward(part.span, x, y)
    return x


def _stage(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
           attention: str, ax: Optional[_Axes]) -> torch.Tensor:
    """The residual stream after this rank's layers: all of them without a
    pp axis; on a pp stage its own, from the embedding on the first stage
    and from the stage before on a later one; the embedding's rows times
    embedding_scale where it is not 1."""
    x = _bf16(params["embed"])[tokens]
    if cfg.embedding_scale != 1:
        x = x * cfg.embedding_scale
    if ax is not None:
        x = gather(x, -1, ax.group["tp"], sum_grads=False)
        if ax.index["pp"] > 0:
            x = pipe_recv(x, ax.stages[ax.index["pp"] - 1])
    return _layers(x, params["layers"], cfg, attention, ax)


def _layers(x: torch.Tensor, layers: Params, cfg: ModelConfig,
            attention: str, ax: Optional[_Axes]) -> torch.Tensor:
    """x through each layer of the stacked `layers`, in order: layer i
    takes the next slice of each leaf of its mixer and MLP (`cfg.kinds`)
    and of each of the block's leaves of every layer (`_block_leaves`);
    under `cfg.remat` each layer is recomputed in the backward."""
    # unbind, not w[i]: its backward stacks the layers' grads once, where
    # each w[i]'s would fill and add a zero grad of the whole stack
    slices = {name: iter(stacked.unbind(0)) for name, stacked in layers.items()}
    n = len(cfg.layer_types) or next(iter(layers.values())).shape[0]
    kinds = cfg.kinds(n)
    leaves, every = _part_leaves(cfg), _block_leaves(cfg)[1]
    names = {kind: (*leaves[kind[0]], *leaves[kind[1]], *every)
             for kind in set(kinds)}
    for kind in kinds:
        layer = {name: next(slices[name]) for name in names[kind]}
        if cfg.remat:
            x = checkpoint(_layer_body, x, layer, cfg, attention, ax, kind,
                           use_reentrant=False)
        else:
            x = _layer_body(x, layer, cfg, attention, ax, kind)
    return x


def _head(params: Params, x: torch.Tensor, ax: Optional[_Axes],
          cfg: ModelConfig) -> torch.Tensor:
    """f32 logits from the last layer's residual stream."""
    return _logits(params, x, ax, cfg).float()


def _logits(params: Params, x: torch.Tensor, ax: Optional[_Axes],
            cfg: ModelConfig) -> torch.Tensor:
    """bf16 logits from the last layer's residual stream: the final
    RMSNorm (`final_norm` in the hybrid block) and the unembedding, tied to
    the embedding (its transpose) where `cfg.tied`, divided by
    logits_scale where it is not 1."""
    x = _block_norm(x, params, "final_norm", cfg)
    if cfg.tied:
        logits = x @ _bf16(params["embed"]).t()
    else:
        if ax is not None:
            # unembed is row-sharded: each rank multiplies its d-slice
            width = params["unembed"].shape[0]
            x = enter(x, ax.group["tp"]).narrow(-1, ax.index["tp"] * width,
                                                width)
        logits = _row_sharded(x, params["unembed"], ax)
    return logits if cfg.logits_scale == 1 else logits / cfg.logits_scale


def _send_on(x: torch.Tensor, ax: _Axes) -> torch.Tensor:
    """An earlier pp stage's end: x sent to the next stage; the f32 zero
    returned receives x's gradient from it in the backward."""
    return pipe_send(x, ax.stages[ax.index["pp"] + 1])


def _forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
             attention: str, ax: Optional[_Axes]) -> torch.Tensor:
    x = _stage(params, tokens, cfg, attention, ax)
    if ax is None or ax.size["pp"] == 1:
        with tracing.span("workload.head"):
            return _head(params, x, ax, cfg)
    # the logits are replicated over pp, as the JAX version's out_shardings
    # replicate them: broadcast from the last stage
    if ax.last_stage():
        logits = _head(params, x, ax, cfg)
    else:
        _send_on(x, ax)
        logits = torch.empty(*tokens.shape, cfg.vocab, device=x.device)
    dist.broadcast(logits, ax.stages[-1], group=ax.group["pp"])
    return logits


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attention: str = "einsum", mesh=None) -> torch.Tensor:
    """Logits (batch, seq, vocab) in f32. On a mesh, `params` are this
    rank's shards and `tokens` its (dp, sp) block; so are the logits,
    which every pp stage returns."""
    with tracing.span("workload.forward", root=True):
        return _forward(params, tokens, cfg, attention, _axes(mesh, cfg))


def _loss(params: Params, rows: torch.Tensor, cfg: ModelConfig,
          attention: str, ax: Optional[_Axes]) -> torch.Tensor:
    """This rank's part of the mean next-token cross-entropy over the
    global batch x (seq - 1) positions. `rows` are the rank's token rows,
    whole: the last position of an sp shard predicts the first token of
    the next; the last global position predicts nothing. On a pp stage
    before the last, the part is 0: the stage's output goes on to the
    next stage, and its gradient comes back from there."""
    seq = rows.shape[1]
    sp, dp = (1, 1) if ax is None else (ax.size["sp"], ax.size["dp"])
    width = seq // sp
    start = 0 if ax is None else ax.index["sp"] * width
    x = _stage(params, rows[:, start:start + width], cfg, attention, ax)
    if ax is not None and not ax.last_stage():
        return _send_on(x, ax)
    targets = rows[:, start + 1:start + width + 1]
    return (_nll_sum(params, x, targets, ax, cfg)
            / (rows.shape[0] * dp * (seq - 1)))


def _nll_sum(params: Params, x: torch.Tensor, targets: torch.Tensor,
             ax: Optional[_Axes], cfg: ModelConfig) -> torch.Tensor:
    """The summed next-token NLL of the last layer's residual stream x
    against `targets`, which may be one position shorter than x (the last
    global position predicts nothing): `xent.nll_sum` of the bf16 logits,
    the kernel pair on a CUDA tensor."""
    with tracing.span("workload.head"):
        nll = xent.nll_sum(_logits(params, x, ax, cfg), targets)
        return tracing.backward("workload.head", x, nll)


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attention: str = "einsum", mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy. On a mesh, `tokens` are the rank's
    dp rows over the whole sequence, and the result is this rank's part of
    the mean (the parts sum to it over dp, sp and pp)."""
    return _loss(params, tokens, cfg, attention, _axes(mesh, cfg))


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
    return _build(tree, iter(leaves))


def _build(node, it) -> Params:
    # module level, not a closure: a recursive closure refers to itself
    # through its cell, and that cycle kept the iterator, hence every leaf
    # it placed (each step's gradients among them), alive until the
    # garbage collector ran
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    return next(it)


def _grad_axes(key: str, spec: Tuple) -> Tuple[str, ...]:
    """The mesh axes a leaf's gradient is summed over: those on which its
    rank holds only a partial. Every leaf over the batch axes dp and sp;
    a leaf that is not cut over pp (embed, unembed: used on the first or
    the last stage only) over pp; the router `wr`, replicated over ep but
    reached on each ep rank through its own experts' gates only, over ep.
    Leaves replicated over ep and computed whole there (attention) are
    not summed over it."""
    axes = ("dp", "sp") + (() if "pp" in spec else ("pp",))
    return axes + (("ep",) if key == "layers.wr" else ())


def value_and_grad(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   attention: str = "einsum", mesh=None
                   ) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) with grads a tree of params' structure; the caller's
    params are not marked as requiring grad. On a mesh the loss is summed
    over dp, sp and pp and each leaf's gradient over `_grad_axes`: every
    rank gets the global loss and the gradient of its shards."""
    ax = _axes(mesh, cfg)
    named = _named_leaves(params)
    leaves = [p.detach().requires_grad_() for _, p in named]
    with torch.enable_grad():
        loss = _loss(_with_leaves(params, leaves), tokens, cfg, attention, ax)
        # a pp stage leaves embed or unembed unused: its gradient is 0
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    if ax is not None:
        present = [name for name in ("dp", "sp", "pp") if name in ax.group]
        loss, = all_reduce_grads([loss], [ax.group[n] for n in present])
        buckets: Dict[Tuple[str, ...], List[int]] = {}
        for i, ((key, _), spec) in enumerate(
                zip(named, _leaves(param_specs(cfg)))):
            axes = tuple(a for a in _grad_axes(key, spec) if a in ax.group)
            buckets.setdefault(axes, []).append(i)
        for axes, idx in buckets.items():
            summed = all_reduce_grads([grads[i] for i in idx],
                                      [ax.group[a] for a in axes])
            for i, g in zip(idx, summed):
                grads[i] = g
    return loss, _with_leaves(params, grads)


def sgd_step(params: Params, momentum: Params, tokens: torch.Tensor,
             cfg: ModelConfig, attention: str = "einsum", mesh=None
             ) -> Tuple[Params, Params, torch.Tensor]:
    """One training step: loss, grads, SGD with momentum.

    m <- momentum * m + g, p <- p - lr * m. params and momentum are updated
    in place (the JAX version donates them) and returned with the loss,
    which is the loss before the update.

    The garbage collector is paused while the step is enqueued
    (`_collector_paused`)."""
    with _collector_paused(), tracing.span("workload.sgd_step", root=True):
        loss, grads = value_and_grad(params, tokens, cfg, attention, mesh)
        with tracing.span("workload.sgd_update"):
            _sgd_update(params, momentum, grads, cfg.momentum, cfg.lr)
    return params, momentum, loss


@contextlib.contextmanager
def _collector_paused():
    """Python's automatic garbage collection off inside, as the caller had
    it after. A step's Python objects (tensors of the graph, the layers'
    leaf dicts) live until the step ends; each collection inside it moves
    the live ones to an older generation, and after a few dozen steps the
    full collection this brings on holds the host for 0.1-0.2 s, longer
    than it runs ahead of the card, which then waits (LFM2 at 2 x 8192 on
    an H100: one step in ~33 took 0.13-0.21 s longer). Paused,
    they die by reference count at the step's end; cyclic garbage waits
    for the next collection outside the step."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _sgd_update(params: Params, momentum: Params, grads: Params,
                beta: float, lr: float) -> None:
    """m <- beta * m + g, p <- p - lr * m, in place."""
    with torch.no_grad():
        for p, m, g in zip(_leaves(params), _leaves(momentum), _leaves(grads)):
            m.mul_(beta).add_(g)
            p.sub_(m, alpha=lr)


def param_specs(cfg: ModelConfig) -> Params:
    """Per leaf, the mesh axis each dimension is sharded over (None =
    replicated), as the JAX version's PartitionSpecs: "pp" on the stacked
    layer dim, "tp" over heads and ffn, "ep" over experts; replicated over
    dp and sp. Axes the mesh lacks drop out (`shard_params`). The hybrid
    block has none (ValueError)."""
    _one_device(cfg)
    layers = {
        "wq": ("pp", None, "tp"), "wk": ("pp", None, "tp"),
        "wv": ("pp", None, "tp"), "wo": ("pp", "tp", None),
    }
    if cfg.n_experts:
        layers["wr"] = ("pp", None, None)
        layers["w1e"] = ("pp", "ep", None, "tp")
        layers["w2e"] = ("pp", "ep", "tp", None)
    else:
        layers["w1"] = ("pp", None, "tp")
        layers["w2"] = ("pp", "tp", None)
    return {"embed": (None, "tp"), "unembed": ("tp", None), "layers": layers}


def shard_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """This rank's shards of a full param tree (the same on every rank:
    `init_params` from one seed, or `params_from_jax`), cut by
    `param_specs`. Raises ValueError where a sharded dimension does not
    divide by its axis, or n_heads by tp (a shard holds whole heads)."""
    names, sizes = mesh.mesh_dim_names, mesh_shape(mesh)
    tp = sizes["tp"]
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads={cfg.n_heads} is not divisible by tp={tp}")

    def cut(key, t, spec):
        for dim, axis in enumerate(spec):
            if axis not in names:
                continue
            n = sizes[axis]
            if t.shape[dim] % n:
                raise ValueError(f"{key}: dimension {dim} of size "
                                 f"{t.shape[dim]} is not divisible by "
                                 f"{axis}={n}")
            t = t.chunk(n, dim)[mesh.get_local_rank(axis)]
        return t.contiguous()

    return _with_leaves(params, [
        cut(key, t, spec) for (key, t), spec in zip(
            _named_leaves(params), _leaves(param_specs(cfg)))])


def _token_rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's dp rows of a (batch, seq) token batch, whole."""
    dp, sp = mesh_shape(mesh)["dp"], mesh_shape(mesh)["sp"]
    batch, seq = tokens.shape
    if batch % dp or seq % sp:
        raise ValueError(f"batch {batch} and seq {seq} must divide by "
                         f"dp={dp} and sp={sp}")
    return tokens.chunk(dp, 0)[mesh.get_local_rank("dp")].contiguous()


# From this sequence length on, `auto` attention takes the flash kernels on
# CUDA: the shortest swept length from which the kernels' training time
# (K1 forward with lse, K2 + K3 backward) beats einsum attention's at every
# longer swept length, at hb 8 and at hb 128 (batch 8 x 16 heads, the mfu
# preset's), head_dim 128, bf16, causal; `attn_bench.crossover` applied to
# docs/validator_h100_attn_pr7.json (one H100 80GB HBM3 at 700 W). Train
# ms, flash / einsum, hb 8: 1.94 / 2.34 at 256, 1.53 / 2.65 at 512, 1.37 /
# 2.10 at 2048; hb 128: 1.597 / 1.594 at 256 (einsum ahead), 1.43 / 2.25
# at 512, 4.25 / 20.95 at 2048, 44.3 / out of memory at 8192. Below it the
# eager call's launches, not the arithmetic, set both times. The JAX
# package's 2048 is a TPU sweep's; explicit "flash" is always honoured.
FLASH_MIN_SEQ = 512


def _resolve(cfg: Optional[ModelConfig], mesh, attention: Optional[str],
             device):
    """Config, device and attention mode for a build.

    None auto-selects ring attention when sp > 1, else the flash kernels on
    CUDA from `FLASH_MIN_SEQ` on, and einsum below it and on the CPU."""
    cfg = cfg or ModelConfig()
    dev = resolve_device(device)
    if mesh is not None:
        _one_device(cfg)
    sp = 1 if mesh is None else mesh_shape(mesh)["sp"]
    if attention is None:
        if sp > 1:
            attention = "ring"
        elif dev.type == "cuda" and cfg.seq_len >= FLASH_MIN_SEQ:
            attention = "flash"
        else:
            attention = "einsum"
    if attention == "flash" and sp != 1:
        raise ValueError("flash attention requires sp == 1 (full local sequence)")
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


def build_workload(cfg: Optional[ModelConfig] = None, mesh=None,
                   seed: int = 0, attention: Optional[str] = None,
                   device=None):
    """Training build, on one device or, with `mesh`, on this rank's shards.

    Returns (step, params, momentum, tokens): `step(params, momentum,
    tokens) -> (params, momentum, loss)` is `sgd_step`, which updates its
    arguments in place; params and tokens are seeded as in `build_infer`
    (on a mesh every rank draws the whole model and batch from the seed and
    keeps its shards and its dp rows, whole); momentum starts at zero."""
    cfg, dev, attention = _resolve(cfg, mesh, attention, device)
    params, tokens = _place(cfg, dev, seed)
    if mesh is not None:
        params, tokens = shard_params(params, cfg, mesh), _token_rows(tokens, mesh)
    momentum = _with_leaves(params, [torch.zeros_like(p)
                                     for p in _leaves(params)])

    def step(p: Params, m: Params, t: torch.Tensor):
        return sgd_step(p, m, t, cfg, attention, mesh)

    return step, params, momentum, tokens


def build_infer(cfg: Optional[ModelConfig] = None, mesh=None, seed: int = 0,
                attention: Optional[str] = None, device=None):
    """Serving-path build, on one device or, with `mesh`, on this rank's
    shards.

    Returns (forward fn -> logits, params, tokens): params from a generator
    seeded with `seed`, a token batch from one seeded with `seed + 1` (on a
    mesh, this rank's (dp, sp) block of it; the logits are the block's).
    The forward runs without autograd and can be called repeatedly."""
    cfg, dev, attention = _resolve(cfg, mesh, attention, device)
    params, tokens = _place(cfg, dev, seed)
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
        sp = mesh_shape(mesh)["sp"]
        tokens = _token_rows(tokens, mesh).chunk(sp, 1)[
            mesh.get_local_rank("sp")].contiguous()

    @torch.no_grad()
    def fwd(p: Params, t: torch.Tensor) -> torch.Tensor:
        return forward(p, t, cfg, attention, mesh)

    return fwd, params, tokens
