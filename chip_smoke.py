#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA. Phases, each of which raises (exit non-zero) on
failure:

1. print the card (`nvidia-smi` name and power limit, torch's name);
2. build every kernel under tpu_device_plugin_torch/validator/csrc/;
3. hold each kernel (K1 the flash forward, K2 and K3 the flash backward)
   against its plain PyTorch version on the card, element by element
   (`tol_ratio` <= 1), at the main path's shape and at small ragged
   shapes, and time the kernel (with its `bound_share` and TFLOP/s), the
   plain version, and the one PyTorch call computing the same function
   (`library_ms`, a yardstick the port never calls), and K2 also at the
   other training cells' attention shapes (K2_CELL_SHAPES), timed beside
   its bound and its first heads held against its plain version, and K3
   so at every training cell's (K3_CELL_SHAPES), into bf16 and f32 dq,
   bit for bit the same on a second launch; K1, K2
   and K3 at latent attention's head dims (q and k 192, v 128) at small
   ragged shapes against their plain versions and timed at
   Moonlight-16B-A3B's attention (LATENT_SHAPE) beside their bounds and
   SDPA's forward and backward; the same for the training head's NLL kernel pair (xent_fwd, xent_bwd) at switch-base-8's
   and pythia-1.4b's head shapes and a ragged vocab, timed at Switch's
   beside its bound by bytes, its plain version and `F.cross_entropy` on
   the f32 logits; and LFM2's gated short convolution (conv_fwd,
   conv_bwd) at LFM2's shape (2 x 8192, d 2048, 3 taps) and at ragged
   ones, timed at LFM2's beside its bound by bytes, its plain version
   and `F.conv1d(groups=d)` with the two gates; and S1, Mamba-2's
   chunked scan (ssd_fwd, ssd_bwd), and C1's ungated mode (conv_silu_fwd,
   conv_silu_bwd) at Granite-4.0-H-Small's one-layer shape (2 x 8192,
   128 heads of 64, state 128; 8448 channels read in place in the
   projection's rows), every output against the plain versions, timed
   beside their bounds and the plain versions (`check_ssd`,
   `check_conv_silu`);
4. drive the serving path at the `mfu` preset through
   `probe.validate_slice(mode="infer")` and the training path through
   `probe.validate_slice(mode="train")`, each with the launch counts set
   to 0 just before it, and assert each is ok and went through its
   kernels (the head's pair once a training step, never in serving; the
   convolution's never: the block has no conv layer); then
   compare one forward's logits, and one training step's loss and
   gradients, with the same computation through the kernels' plain
   versions on the same weights, at mfu and at a small configuration;
5. run ring flash attention at the mfu attention shape over sp 2 and 4
   on this one card (the ring's ranks as threads, each on its own
   stream), hold o, lse, dq, dk and dv against global attention through
   the plain versions and count sp (sp + 1) / 2 launches of each kernel
   per ring; time K1, K2 and K3 in the ring's step modes (full, f32
   gradients) beside their bounds and SDPA; then take one training step at
   mfu through the mesh path over NCCL at world size 1 and require it bit
   for bit equal to the no-mesh step (what a one-card machine can show of
   the NCCL path: the collectives between cards need several cards);
6. the top-1 switch MoE at the mfu width with 4 experts: the training
   and the serving path through `validate_slice`, each with the launch
   counts set to 0 just before it (K1, K2 and K3 n_layers times per step;
   K1 n_layers times per forward and no K2 or K3); the scatter dispatch
   against its one-hot plain version on one layer's input, bit for bit;
   and one MoE training step through the kernels against the same step
   through their plain versions, on the same weights, with the route
   agreement of the two;
7. LFM2's hybrid block at LFM2's widths and the cell's 2 x 8192 tokens,
   cut to 4 layers (3 conv, 1 attention): `workload.sgd_step` and
   `workload.forward`, each with the launch counts set to 0 just before
   it (conv_fwd and conv_bwd once a conv layer per step, with b s
   `conv.fused_rows` each; K1-K3 once an attention layer; the head's pair
   once; a forward conv_fwd and K1 alone); then one step's loss and
   gradients against the same step with `short_conv.gated_conv_plain` in
   the kernels' place. Then DeepSeek-V3's block at Moonlight-16B-A3B's
   widths and 2 x 8192 tokens under remat, cut to 3 layers, the same way
   (K1 twice an MLA layer a step, K2 and K3 once, b s heads
   `mla.flash_rows` a layer; a forward K1 alone), and one step's loss and
   gradients against the same step with K1-K3's plain versions in their
   place, on the kernel step's routes; then Granite-4.0-H's block at
   granite-4.0-h-small's widths and 2 x 8192 tokens under remat, cut to
   one Mamba-2 and one attention layer (`check_granite_block`): S1 and
   C1's ungated pair once a Mamba layer a step (b s heads
   `mamba.scan_rows`), K1 twice and K2, K3 once the attention layer; a
   forward their forwards alone; one step's loss and gradients against
   the same step with `ssd.ssd_plain` and `short_conv.conv_silu_plain` in
   the kernels' place;
8. GPipe at the mfu preset: pp 2 as two threads of this process on the
   one card (`pipeline.ThreadLink`, each stage on its own stream; NCCL
   refuses two ranks on one card), 4 microbatches: one step's loss and
   gradients against the non-pipelined step on the same weights (einsum
   attention on both sides, so no kernel launches), then a few steps whose
   loss must fall, with the step time differenced as `_train` does;
9. the benches: `attn_bench.bench_attention` at hb 8 (seq 1024, 2048,
   4096) and hb 128 (seq 2048), `ring_bench.bench_ring` at seq 4096 over
   sp 1 (this process) and sp 2 (threads), each counted from 0: the flash
   side ok in every cell, K1, K2 and K3 launched by every train chain, K1
   alone by every forward chain;
10. the multi-process slice as a guest runs it: the CLI (`python -m
   tpu_device_plugin_torch.validator --preset mfu`) in subprocesses, joined
   as the one process of a world (`--coordinator 127.0.0.1:PORT
   --num-processes 1 --process-id 0`; NCCL refuses two ranks on one card,
   so the world has one guest), its rank a fresh process on the card:
   training must be ok with loss_start bit for bit phase 4's and K1, K2
   and K3 launched n_layers times per step in that process; serving ok
   with K1 alone; the joined training's rendezvous_s, first_step_s and
   step_time_s beside phase 4's; and a coordinator nobody serves (`--init-timeout 5`): a JSON report
   with `ok` false and `error` "distributed init: ...", exit 1, in time;
11. print one JSON line of kernels (launches by path, the benches' and the
   multi-process runs' too; the short convolution's from phase 7), then,
   last, the device line.

Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import socket
import subprocess
import sys
import time
from unittest import mock

# NVIDIA H100 SXM datasheet peaks: dense bf16 tensor-core and f32
# non-tensor-core FLOP/s, and HBM bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Each kernel vs its plain version, element by element:
# |d| <= ATOL x max(max |g|, 1) + RTOL x |g| + FLIP_RTOL x term.
# Both compute in f32 from the same inputs (and, in the backward, the same
# lse and D), and the plain version's f32 result is the reference. A bf16
# output rounds to within half an ulp, at most 2^-8 of |g|, so bf16 is held
# to one ulp (2^-7); f32 outputs differ only by summation order. The
# absolute term covers elements near 0, where only f32 summation noise is
# left, and gradients that vanish (seq 1: one key, dq and dk are rounding
# noise); at the mfu shape, where max |g| is near 5 and most elements are
# a few hundredths, it is 5e-4 in bf16. With bf16 inputs K1 rounds P, K2
# P and dS, and K3 dS, to bf16, as their plain versions do; their scores
# come from another summation order, so now and then one of them rounds
# the other way, by one bf16 ulp (at most 2^-7 of it): `term` is the
# largest single term of the element's sum
# (flash_attention.rounding_terms_fwd, _dkv, _dq), allowed once.
GRAD_RTOL = {"bfloat16": 2 ** -7, "float32": 1e-4}
GRAD_ATOL = {"bfloat16": 1e-4, "float32": 1e-5}
FLIP_RTOL = 2 ** -7
LSE_TOL = 1e-3
# K2 timed also at the attention of the other training cells, causal bf16:
# {cell: (hb, seq, d, heads held against the plain version)}; LFM2's 2 x
# 32 expanded heads over 8192, Switch's 128 x 12 heads over 512. K2 makes
# each head's dk and dv apart from the others', so the first heads alone
# are compared (the plain version of all of LFM2's would need some 70 GB).
K2_CELL_SHAPES = {"lfm2-8b-a1b.train": (64, 8192, 64, 2),
                  "switch-base-8.train": (1536, 512, 64, 16)}
# K3 timed at the attention of every training cell, causal bf16, the same
# way: {cell: (hb, seq, q/k head dim, v head dim, heads held against the
# plain version)}; Moonlight-16B-A3B's 2 x 16 heads over 8192 at latent
# attention's head dims.
K3_CELL_SHAPES = {"pythia-1.4b.train": (128, 2048, 128, 128, 8),
                  "lfm2-8b-a1b.train": (64, 8192, 64, 64, 2),
                  "switch-base-8.train": (1536, 512, 64, 64, 16),
                  "moonlight-16b-a3b.train": (32, 8192, 192, 128, 2)}
# K1-K3 at latent attention's head dims: (hb, seq, q/k head dim, v head
# dim) of Moonlight-16B-A3B's training cell, 2 x 16 heads over 8192
# (timed, and its first LATENT_HEADS heads held against the plain
# versions, as K2_CELL_SHAPES), and the ragged shapes held against them
LATENT_SHAPE = (32, 8192, 192, 128)
LATENT_HEADS = 2
LATENT_CHECKS = [(2, 1), (2, 96), (3, 200), (2, 1000)]
# The head's NLL kernels vs their plain version, from the same bf16
# logits in f32: each row's lse and NLL within NLL_ATOL (exp is
# ex2.approx, ~2^-22 relative; the row's sums run in another order), the
# summed loss within NLL_RTOL. The bf16 gradient g (p - onehot): each side
# computes p within a few 1e-6 of it, relative, and rounds once, so
# |d| <= 2^-7 |ref| (one ulp) + XENT_GRAD_ATOL (p flushed to 0 under
# 2^-126), and at each target XENT_TARGET_ATOL |g| more (p - 1 loses the
# relative precision of p); rows past T exactly 0.
NLL_ATOL = 1e-4
NLL_RTOL = 1e-5
XENT_GRAD_ATOL = 1e-30
XENT_TARGET_ATOL = 1e-5
# (B, S, T, V): switch-base-8's head (timed), pythia-1.4b's, a ragged vocab
XENT_SHAPES = [(128, 512, 511, 32128), (8, 2048, 2047, 50304),
               (2, 96, 95, 1001)]
# LFM2's gated short convolution vs its plain version: the same bf16
# roundings of exact products, only the f32 sums in another order, so y
# within one bf16 ulp of the plain y per element (`ulp_ratio` <= 1), dbch
# by the element bar above (`tol_ratio` <= 1). Each tap's gradient, an
# f32 sum of b s bf16 products, against the exact (f64) sum of those
# products: within `short_conv.dw_sum_depth(b, s)` 2^-24 of the sum of
# their absolute values (`dw_ratio` <= 1), the most additions any term
# passes through in the kernels' order (104 at LFM2's shape, where one
# tile's partial left out, some sqrt(64) terms' worth, is about 100 times
# the bar). (b, s, d, K): LFM2's (timed), ragged ones.
CONV_SHAPES = [(2, 8192, 2048, 3), (3, 200, 136, 2), (2, 197, 64, 4)]
# S1 (Mamba-2's chunked scan) vs its plain version: both round M, the
# state read by C, x dt exp(..) and y to bf16 from f32 sums in another
# order (mma vs einsum), so a bf16 rounding now and then falls the other
# way and moves what follows it by 2^-8 of one term. Over the cell's one
# layer (b, s, heads, head dim, state, groups) on an H100 the largest |d|
# over max |ref| read 1.1e-3 in y, 8.0e-3 in dx, 2.8e-3 in d dt, 9.1e-3 in
# da, 4.0e-3 in dB, 4.8e-3 in dC, 2.4e-7 in dD: each
# bar about twice that. The state passed without its decay, or y without
# D's skip, reads 0.3 or more in y. Plain over SSD_PLAIN_HEADS heads at a
# time (the heads of one group share B and C; dB and dC are summed over
# the groups of heads in f32).
SSD_SHAPE = (2, 8192, 128, 64, 128, 1)
SSD_TOL = {"y": 4e-3, "dx": 2e-2, "ddt": 1e-2, "da": 2e-2, "dB": 1e-2,
           "dC": 1e-2, "dD": 1e-4}
SSD_PLAIN_HEADS = 16
# C1's ungated mode vs its plain version: the same f32 sum in the same
# order, but fused multiply-adds against PyTorch's products and sums, and
# expf against torch's exp in the SiLU. Where the sum nearly cancels, silu
# is near s / 2 and keeps the sum's absolute error, some 5 roundings of
# 2^-24 of its terms' magnitudes: so y within one bf16 ulp plus
# CONV_SILU_SUM_TOL times the sum of |w_j x_j| and |bias| (`y_ratio` <=
# 1; at Granite's one layer, 138 M outputs, one bf16 ulp alone read 64),
# dx likewise against the sum of |g w_j| (g the sum's f32 gradient, with
# the error the sum's own carries into it), the
# taps' and the bias's f32 gradients within CONV_SILU_DW_TOL of the
# largest (2.6e-7 read). (b, s, D, row stride): Granite's xBC read in
# place in its projection (timed), ragged.
CONV_SILU_SHAPES = [(2, 8192, 8448, 16768), (3, 200, 136, 136),
                    (2, 197, 64, 200)]
CONV_SILU_DW_TOL = 1e-5
CONV_SILU_SUM_TOL = 2 ** -21
# Granite-4.0-H's block at granite-4.0-h-small's widths, cut to one Mamba-2
# layer and one attention layer, 2 x 8192, remat: the kernel step against
# the plain one (S1 and C1's ungated mode in plain PyTorch), held to
# STEP_GRAD_REL_TOL and STEP_LOSS_TOL with each leaf's gradient gap taken
# over the larger of its norm and the median leaf's (`check_granite_block`)
GRANITE_BLOCK = dict(vocab=100352, d_model=4096, n_heads=32, n_kv_heads=8,
                     d_ff=768, n_layers=2, layer_types=["mamba", "attention"],
                     n_experts=72, experts_held=9, expert_d_ff=768,
                     experts_per_token=10, norm_eps=1e-5, shared_d_ff=1536,
                     mamba_heads=128, mamba_head_dim=64, mamba_state=128,
                     mamba_groups=1, mamba_taps=4, attention_scale=1 / 128,
                     router_scores="softmax", embedding_scale=12.0,
                     residual_scale=0.22, logits_scale=16.0, remat=True,
                     batch=2, seq_len=8192)
# One training step through the kernels vs the same step through the plain
# versions: only the attention's summation order and bf16 roundings of its
# outputs differ, fed through 8 bf16 layers; the port's step against the
# JAX package's differs by at most 1.6% of max |g| per leaf and 5.2e-4 in
# the loss (tests/test_torch_train.py). Held to 3% per leaf and 1e-3.
STEP_GRAD_REL_TOL = 0.03
STEP_LOSS_TOL = 1e-3
# A forward through the kernel vs the same forward through its plain
# version: only the attention's summation order, hence some 1-ulp bf16
# roundings of P and of its output, differ. Max |dlogit| <= 2% of max
# |logit|, and argmax agreement >= 99% at the small configuration below.
# At mfu (vocab 256, 8 bf16 layers, random weights) near-tied logits make
# argmax sensitive to those roundings alone: on an H100 the scalar K1
# agreed with its plain version on 98.3% of positions and with the einsum
# forward on 98.0%, the tensor-core K1 on 98.2% and 97.9%, at max |dlogit|
# 1.0% and 1.3% both; so mfu is held to 97%.
LOGIT_REL_TOL = 0.02
ARGMAX_AGREE_MIN = 0.99
ARGMAX_AGREE_MIN_MFU = 0.97
# the configuration the port's tolerances were sized at
SMALL = dict(vocab=64, d_model=64, n_heads=4, d_ff=128, n_layers=2,
             seq_len=96, batch=2)
# The MoE step through the kernels vs the same step through their plain
# versions. Top-1 routing turns a router logit moved by the attention's
# roundings into a whole token's difference where a token's two best
# logits tie at that level, so the plain step takes the kernel step's
# routes (with its own gates): then only the attention's roundings differ,
# as in the dense step, and the dense bars hold (STEP_GRAD_REL_TOL,
# STEP_LOSS_TOL). The plain step's own routes must agree with the kernel
# step's on at least 99% of the 8 layers x 16384 tokens, and every
# disagreement must be a tie within its layer's largest logit difference.
MOE_EXPERTS = 4
MOE_ROUTE_AGREE_MIN = 0.99
# Phase 7: LFM2's hybrid block at LFM2's widths (d 2048, 32 query heads
# over 8 key-value heads, 3 taps, SwiGLU 7168, top-4 of 32 experts of 1792
# with 8 held) and the cell's 2 x 8192 tokens a step, cut to 4 layers (3
# conv, 1 attention; 1 dense, 3 MoE). Its step through the conv kernels
# against the same step with the plain convolution in their place: the
# kernels give y and dbch bit for bit the plain version's, so where two
# kernel steps agree bit for bit the plain step must give the same loss
# and every gradient but the taps' bit for bit, and the taps' within the
# dense step's bar (STEP_GRAD_REL_TOL); where they do not, the dense
# step's bars hold.
HYBRID = dict(vocab=65536, d_model=2048, n_heads=32, n_kv_heads=8,
              d_ff=7168, n_layers=4,
              layer_types=("conv", "conv", "full_attention", "conv"),
              n_dense_layers=1, n_experts=32, experts_held=8,
              expert_d_ff=1792, experts_per_token=4, rope_theta=1e6,
              norm_eps=1e-5, seq_len=8192, batch=2)
HYBRID_STEPS = 3
# Phase 7 too: DeepSeek-V3's block at Moonlight-16B-A3B's widths (d 2048,
# 16 heads of q/k 128 + 64 RoPE dims over v 128, a latent of 512, SwiGLU
# 11264, top-6 of 64 experts of 1408 with 8 held beside shared experts of
# 2816, vocab 163840 untied) and its cell's 2 x 8192 tokens under remat,
# cut to 3 layers (1 dense, 2 MoE). Its step through K1-K3 against the
# same step with their plain versions in their place (PLAIN_HEADS heads
# at a time, so that the f32 scores fit), on the kernel step's routes:
# only attention's summation order and bf16 roundings differ, as in the
# dense step, whose bars hold (STEP_GRAD_REL_TOL, STEP_LOSS_TOL).
LATENT_BLOCK = dict(vocab=163840, d_model=2048, n_heads=16, d_ff=11264,
                    n_layers=3, layer_types=("mla",) * 3, n_dense_layers=1,
                    n_experts=64, experts_held=8, expert_d_ff=1408,
                    experts_per_token=6, rope_theta=50000.0, norm_eps=1e-5,
                    kv_lora_rank=512, qk_nope_head_dim=128,
                    qk_rope_head_dim=64, v_head_dim=128, shared_d_ff=2816,
                    routed_scale=2.446, router_eps=1e-20, untied_head=True,
                    remat=True, seq_len=8192, batch=2)
LATENT_BLOCK_STEPS = 2
PLAIN_HEADS = 4
# GPipe at mfu on one card: 2 stages as threads, 4 microbatches of 2 rows.
# The same model and bars as the dense step (STEP_LOSS_TOL,
# STEP_GRAD_REL_TOL): only the microbatches' bf16 roundings and the order
# of the gradient sums differ from the non-pipelined step (the JAX
# package's own GPipe is within 1.4e-6 in the loss and 0.02% in each
# leaf's norm of its plain step, tests/test_torch_pipeline.py's config).
GPIPE_STAGES = 2
GPIPE_MICRO = 4
# Phase 10: the CLI's --steps for training and serving (phase 4's), and a
# coordinator nobody serves: the join must give up after INIT_TIMEOUT_S and
# the CLI exit within INIT_TIMEOUT_S + INIT_SLACK_S (its own start, torch's
# import and the card's enumeration included)
MP_STEPS = {"train": 3, "infer": 5}
INIT_TIMEOUT_S = 5
INIT_SLACK_S = 30


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _memory(torch, phase: str) -> None:
    """One line of the card's memory as a phase starts: allocated before
    and after collecting Python's garbage (what only a collection frees is
    held by reference cycles), and reserved after emptying the
    allocator's cache."""
    before = torch.cuda.memory_allocated()
    unreachable = gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps(dict(phase=phase, allocated_gb_before_gc=before / 1e9,
                          unreachable_objects=unreachable,
                          allocated_gb=torch.cuda.memory_allocated() / 1e9,
                          reserved_gb=torch.cuda.memory_reserved() / 1e9)),
          flush=True)


def _cuda_ms(torch, fn, iters: int) -> float:
    """Mean device ms per call over `iters` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(hb: int, seq: int, d: int, dtype: str, causal: bool):
    """Least time (ms) for attention on the card, what bounds it, and the
    FLOPs. Operations: QK^T and PV over the (causal) score pairs, 2 FLOPs
    per multiply-add each. Bytes: q, k, v read once, o written once."""
    itemsize = 2 if dtype == "bfloat16" else 4
    flops = 4.0 * hb * d * _pairs(seq, causal)
    return (*_bound(flops, 4 * hb * seq * d * itemsize, dtype), flops)


def _pairs(seq: int, causal: bool) -> int:
    return seq * (seq + 1) // 2 if causal else seq * seq


def _bound(flops: float, nbytes: float, dtype: str):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_bounds(hb: int, seq: int, d: int, dtype: str, causal: bool,
               out_dtype: str = None):
    """Least time (ms) for K2 and for K3 on the card, what bounds each, and
    their FLOPs.

    Operations, 2 FLOPs per multiply-add: K2 recomputes QK^T, computes
    dO V^T, P^T dO and dS^T Q (8 d per pair); K3 QK^T, dO V^T and dS K
    (6 d per pair). Bytes: q, k, v, dO read once, lse and D (f32 rows)
    read once, and K2's dk, dv or K3's dq written once (in `out_dtype`,
    default `dtype`)."""
    itemsize = 2 if dtype == "bfloat16" else 4
    out_itemsize = 2 if (out_dtype or dtype) == "bfloat16" else 4
    tile = hb * seq * d
    rows = 2 * hb * seq * 4
    pairs = hb * _pairs(seq, causal)
    out = {}
    for name, per_pair, reads, writes in (("flash_bwd_dkv", 8, 4, 2),
                                          ("flash_bwd_dq", 6, 4, 1)):
        flops = per_pair * d * pairs
        nbytes = tile * (reads * itemsize + writes * out_itemsize) + rows
        out[name] = (*_bound(flops, nbytes, dtype), flops)
    return out


def latent_bounds(hb: int, seq: int, d: int, dv: int, causal: bool = True):
    """Least time (ms) for K1, K2 and K3 at query/key head dim d and value
    head dim dv (bf16), what bounds each, and their FLOPs: each product at
    its own dim, 2 FLOPs per multiply-add (K1: QK^T, PV; K2: S^T, dP^T,
    dV, dK; K3: S, dP, dQ). Bytes: q, k (d) and v, dO (dv) read once as
    each kernel reads them, lse and D rows, o, dk, dv or dq written
    once."""
    pairs = hb * _pairs(seq, causal)
    q, v, rows = 2 * hb * seq * d, 2 * hb * seq * dv, 4 * hb * seq
    work = {"flash_fwd": (2 * pairs * (d + dv), 2 * q + 2 * v + rows),
            "flash_bwd_dkv": (4 * pairs * (d + dv),
                              3 * q + 3 * v + 2 * rows),
            "flash_bwd_dq": (2 * pairs * (2 * d + dv),
                             3 * q + 2 * v + 2 * rows)}
    return {name: (*_bound(flops, nbytes, "bfloat16"), flops)
            for name, (flops, nbytes) in work.items()}


def _latent_errs(fa, q, k, v, do, o, lse, di, dq, dk, dv, scale,
                 causal) -> dict:
    """{kernel: `_elem_err`} of K1's o, K2's dk and dv (the larger) and
    K3's dq against the plain versions with their rounding terms, and
    K1's lse error (`lse_err`)."""
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, True)
    args = (q, k, v, do, lse, di, scale, causal)
    ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args)
    term_dk, term_dv = fa.rounding_terms_dkv(*args)
    err_dk = _elem_err(dk, ref_dk, "bfloat16", term_dk)
    err_dv = _elem_err(dv, ref_dv, "bfloat16", term_dv)
    del ref_dk, ref_dv, term_dk, term_dv
    return {"flash_fwd": _elem_err(o, ref_o, "bfloat16",
                                   fa.rounding_terms_fwd(q, k, v, ref_lse,
                                                         scale, causal)),
            "flash_bwd_dkv": {key: max(err_dk[key], err_dv[key])
                              for key in err_dk},
            "flash_bwd_dq": _elem_err(
                dq, fa.flash_bwd_dq_plain(*args), "bfloat16",
                fa.rounding_terms_dq(*args)),
            "lse_err": (lse - ref_lse).abs().max().item()}


def check_flash_latent(torch, fa, dev) -> list:
    """Phase 3 for K1, K2 and K3 at latent attention's head dims: each
    LATENT_CHECKS shape (causal and not) against the plain versions, then
    each kernel timed at LATENT_SHAPE beside its bound, and SDPA's forward
    and backward (dq, dk, dv together) on the same (b, heads) tensors, and
    its first LATENT_HEADS heads held against the plain versions.
    Returns the timed lines, K1's, K2's, K3's."""
    import torch.nn.functional as F
    gen = torch.Generator(dev).manual_seed(3)
    _, _, d, dv = LATENT_SHAPE
    scale = d ** -0.5

    def make(hb, seq):
        q, k = (torch.randn((hb, seq, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        v, do = (torch.randn((hb, seq, dv), generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        return q, k, v, do

    for (hb, seq), causal in [(sh, c) for sh in LATENT_CHECKS
                              for c in (True, False)]:
        q, k, v, do = make(hb, seq)
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
        di = (do.float() * o.float()).sum(-1)
        dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
        fa.launch_bwd(q, k, v, do, lse, di, dq, dk, dvv, scale, causal)
        torch.cuda.synchronize()
        errs = _latent_errs(fa, q, k, v, do, o, lse, di, dq, dk, dvv, scale,
                            causal)
        lse_err = errs.pop("lse_err")
        for name, err in errs.items():
            ok = err["tol_ratio"] <= 1.0 and (name != "flash_fwd"
                                              or lse_err <= LSE_TOL)
            line = dict(kernel=name, hb=hb, seq=seq, d=d, dv=dv,
                        dtype="bfloat16", causal=causal, **err, ok=ok)
            print(json.dumps(line), flush=True)
            if not ok:
                raise AssertionError(f"{name} at ({d}, {dv}) disagrees with "
                                     f"its plain version: {line}")
    hb, seq = LATENT_SHAPE[:2]
    q, k, v, do = make(hb, seq)
    o, lse = fa.flash_attention_fwd(q, k, v, scale, True, True)
    di = (do.float() * o.float()).sum(-1)
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    ms = {"flash_fwd": _cuda_ms(torch, lambda: fa.flash_attention_fwd(
              q, k, v, scale, True, True), 10),
          "flash_bwd_dkv": _cuda_ms(torch, lambda: fa.launch_bwd(
              q, k, v, do, lse, di, None, dk, dvv, scale, True), 10),
          "flash_bwd_dq": _cuda_ms(torch, lambda: fa.launch_bwd(
              q, k, v, do, lse, di, dq, None, None, scale, True), 10)}
    b = 2
    q4, k4, v4 = (t.view(b, hb // b, seq, -1).detach().requires_grad_()
                  for t in (q, k, v))
    library = {}
    try:
        library["forward"] = _cuda_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 10)
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        do4 = do.view(b, hb // b, seq, dv)
        library["backward"] = _cuda_ms(torch, lambda: torch.autograd.grad(
            out4, (q4, k4, v4), do4, retain_graph=True), 10)
        del out4
    except RuntimeError as exc:          # no SDPA kernel takes the pair
        library["error"] = str(exc)[:200]
    del q4, k4, v4
    torch.cuda.empty_cache()
    # the first heads of the timed outputs: each head's are its own
    heads = LATENT_HEADS
    errs = _latent_errs(fa, *(t[:heads] for t in (q, k, v, do, o, lse, di,
                                                   dq, dk, dvv)), scale, True)
    lse_err = errs.pop("lse_err")
    finite = all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dvv))
    timed = []
    for name, (bound_ms, bound_by, flops) in latent_bounds(
            hb, seq, d, dv).items():
        fwd = name == "flash_fwd"
        ok = finite and errs[name]["tol_ratio"] <= 1.0 and (
            not fwd or lse_err <= LSE_TOL)
        line = dict(kernel=name, hb=hb, seq=seq, d=d, dv=dv,
                    dtype="bfloat16", causal=True, ms=ms[name],
                    bound_ms=bound_ms, bound_by=bound_by,
                    **_speed(ms[name], bound_ms, flops),
                    library_ms=library.get("forward" if fwd else "backward"),
                    library_is=("SDPA forward" if fwd else
                                "SDPA backward: dq, dk and dv together"),
                    library_error=library.get("error"),
                    checked_heads=heads, **errs[name],
                    **(dict(lse_err=lse_err) if fwd else {}), ok=ok)
        print(json.dumps(line), flush=True)
        timed.append(line)
        if not ok:
            raise AssertionError(f"{name} at ({d}, {dv}) disagrees with its "
                                 f"plain version at {LATENT_SHAPE}: {line}")
    del q, k, v, do, o, lse, di, dq, dk, dvv
    torch.cuda.empty_cache()
    return timed


def _speed(ms: float, bound_ms: float, flops: float) -> dict:
    """`bound_share` (bound / time) and the achieved TFLOP/s."""
    return dict(bound_share=bound_ms / ms, tflops=flops / ms * 1e-9)


def _elem_err(out, ref, dt: str, term=None) -> dict:
    """How far a kernel's output is from its plain version: max |d|, that
    over max(max |ref|, 1), |d| / |ref| in the L2 norm (|ref| no smaller
    than the absolute term's norm, for outputs that vanish), and
    `tol_ratio`, the largest |d| / bar over the elements (held to <= 1;
    the bar is the one above, `term` the rounding term or None)."""
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    scale = max(ref.abs().max().item(), 1.0)
    atol = GRAD_ATOL[dt] * scale
    bar = atol + GRAD_RTOL[dt] * ref.abs()
    if term is not None:
        bar = bar + FLIP_RTOL * term
    err = diff.max().item()
    ref_norm = max(ref.norm().item(), atol * ref.numel() ** 0.5)
    return dict(max_abs_err=err, max_rel_err=err / scale,
                rel_l2_err=diff.norm().item() / ref_norm,
                tol_ratio=(diff / bar).max().item())


def check_flash_fwd(torch, fa, dev):
    """Phase 3 for K1: every shape against the plain version; times at the
    serving shape. Returns the kernel's JSON entry (launches filled later)."""
    import torch.nn.functional as F
    gen = torch.Generator(dev).manual_seed(0)
    shapes = [(128, 2048, 128, "bfloat16", True)]            # serving path
    shapes += [(2, seq, d, dt, causal) for seq in (1, 96, 200)
               for d in (16, 128) for dt in ("bfloat16", "float32")
               for causal in (True, False)]
    checks = []
    for hb, seq, d, dt, causal in shapes:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((hb, seq, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        scale = d ** -0.5
        o, lse = fa.flash_attention(q, k, v, None, causal, True)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attention_plain(q, k, v, scale, causal, True)
        term = (fa.rounding_terms_fwd(q, k, v, ref_lse, scale, causal)
                if dt == "bfloat16" else None)
        err = _elem_err(o, ref_o, dt, term)
        del term, ref_o
        err_lse = (lse - ref_lse).abs().max().item()
        ok = (err["tol_ratio"] <= 1.0 and err_lse <= LSE_TOL
              and bool(torch.isfinite(o).all()))
        line = dict(kernel="flash_fwd", hb=hb, seq=seq, d=d, dtype=dt,
                    causal=causal, **err, lse_max_abs_err=err_lse,
                    rtol=GRAD_RTOL[dt], atol_of_max=GRAD_ATOL[dt],
                    lse_tol=LSE_TOL, ok=ok)
        print(json.dumps(line), flush=True)
        checks.append(line)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees with its plain version: {line}")
        torch.cuda.empty_cache()

    hb, seq, d, dt, causal = shapes[0]
    q, k, v = (torch.randn((hb, seq, d), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    # timed as the serving path calls it: causal, no lse
    ms = _cuda_ms(torch, lambda: fa.flash_attention(q, k, v, None, True), 20)
    plain_ms = _cuda_ms(
        torch, lambda: fa.flash_attention_plain(q, k, v, d ** -0.5, True), 5)
    b = 8   # the mfu batch; the 16 heads fold with it into hb = 128
    q4, k4, v4 = (t.view(b, hb // b, seq, d) for t in (q, k, v))
    library_ms = _cuda_ms(
        torch, lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True), 20)
    bound_ms, bound_by, flops = attention_bound(hb, seq, d, dt, causal)
    speed = _speed(ms, bound_ms, flops)
    print(json.dumps(dict(kernel="flash_fwd", hb=hb, seq=seq, d=d, dtype=dt,
                          ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound_ms, bound_by=bound_by, **speed)),
          flush=True)
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_device_plugin_torch/validator/csrc/flash_fwd.cu",
        "replaces": "tpu_device_plugin/validator/flash_attention.py:61",
        "launches": 0,
        "max_abs_err": checks[0]["max_abs_err"],
        "max_rel_err": checks[0]["max_rel_err"],
        "rel_l2_err": checks[0]["rel_l2_err"],
        "tol_ratio": checks[0]["tol_ratio"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        **speed,
        "library_ms": library_ms,
        "library_is": "SDPA forward",
        "ok": all(c["ok"] for c in checks),
        "checks": len(checks),
    }


def check_flash_bwd(torch, fa, dev):
    """Phase 3 for K2 and K3: every shape against the plain versions, with
    o and lse from K1 as on the training path; times at the training
    shape. Returns the two kernels' JSON entries (launches filled later)."""
    import torch.nn.functional as F
    gen = torch.Generator(dev).manual_seed(1)
    shapes = [(128, 2048, 128, "bfloat16", True)]            # training path
    shapes += [(2, seq, d, dt, causal) for seq in (1, 96, 200)
               for d in (16, 128) for dt in ("bfloat16", "float32")
               for causal in (True, False)]
    errs = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for hb, seq, d, dt, causal in shapes:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn((hb, seq, d), generator=gen, device=dev)
                       .to(dtype) for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
        di = (do.float() * o.float()).sum(-1)
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        fa.launch_bwd(q, k, v, do, lse, di, None, dk, dv, scale, causal)
        fa.launch_bwd(q, k, v, do, lse, di, dq, None, None, scale, causal)
        torch.cuda.synchronize()
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, di, scale,
                                                causal)
        term_dk, term_dv = (
            fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, causal)
            if dt == "bfloat16" else (None, None))
        err_dk = _elem_err(dk, ref_dk, dt, term_dk)
        err_dv = _elem_err(dv, ref_dv, dt, term_dv)
        err_dkv = {key: max(err_dk[key], err_dv[key]) for key in err_dk}
        del ref_dk, ref_dv, term_dk, term_dv
        term_dq = (fa.rounding_terms_dq(q, k, v, do, lse, di, scale, causal)
                   if dt == "bfloat16" else None)
        err_dq = _elem_err(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, di,
                                                     scale, causal), dt,
                           term_dq)
        del term_dq
        torch.cuda.empty_cache()
        for name, err in (("flash_bwd_dkv", err_dkv),
                          ("flash_bwd_dq", err_dq)):
            ok = err["tol_ratio"] <= 1.0 and all(
                bool(torch.isfinite(t).all()) for t in (dq, dk, dv))
            line = dict(kernel=name, hb=hb, seq=seq, d=d, dtype=dt,
                        causal=causal, **err, rtol=GRAD_RTOL[dt],
                        atol_of_max=GRAD_ATOL[dt], ok=ok)
            print(json.dumps(line), flush=True)
            errs[name].append(line)
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {line}")

    hb, seq, d, dt, causal = shapes[0]
    q, k, v, do = (torch.randn((hb, seq, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
    di = (do.float() * o.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ms = {"flash_bwd_dkv": _cuda_ms(torch, lambda: fa.launch_bwd(
              q, k, v, do, lse, di, None, dk, dv, scale, causal), 10),
          "flash_bwd_dq": _cuda_ms(torch, lambda: fa.launch_bwd(
              q, k, v, do, lse, di, dq, None, None, scale, causal), 10)}
    plain_ms = {"flash_bwd_dkv": _cuda_ms(torch, lambda: fa.flash_bwd_dkv_plain(
                    q, k, v, do, lse, di, scale, causal), 3),
                "flash_bwd_dq": _cuda_ms(torch, lambda: fa.flash_bwd_dq_plain(
                    q, k, v, do, lse, di, scale, causal), 3)}
    torch.cuda.empty_cache()
    # yardstick: SDPA's backward computes dq, dk and dv together, so it is
    # one figure for K2 + K3
    b = 8
    q4, k4, v4 = (t.view(b, hb // b, seq, d).detach().requires_grad_()
                  for t in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(b, hb // b, seq, d)
    library_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), 10)
    del out4
    bounds = bwd_bounds(hb, seq, d, dt, causal)
    entries = []
    for name, line, replaces in (
            ("flash_bwd_dkv", "K2",
             "tpu_device_plugin/validator/flash_attention.py:196"),
            ("flash_bwd_dq", "K3",
             "tpu_device_plugin/validator/flash_attention.py:236")):
        bound_ms, bound_by, flops = bounds[name]
        speed = _speed(ms[name], bound_ms, flops)
        print(json.dumps(dict(kernel=name, hb=hb, seq=seq, d=d, dtype=dt,
                              ms=ms[name], plain_ms=plain_ms[name],
                              library_ms_k2_plus_k3=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by, **speed)),
              flush=True)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_device_plugin_torch/validator/csrc/flash_bwd.cu",
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": errs[name][0]["max_abs_err"],
            "max_rel_err": errs[name][0]["max_rel_err"],
            "rel_l2_err": errs[name][0]["rel_l2_err"],
            "tol_ratio": errs[name][0]["tol_ratio"],
            "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **speed,
            "library_ms": library_ms,
            "library_is": "SDPA backward: dq, dk and dv, K2 + K3 together",
            "ok": all(c["ok"] for c in errs[name]),
            "checks": len(errs[name]),
        })
    entries[0]["at_cells"] = time_dkv_at_cells(torch, fa, dev, gen)
    entries[1]["at_cells"] = time_dq_at_cells(torch, fa, dev, gen)
    return entries


def time_dkv_at_cells(torch, fa, dev, gen) -> list:
    """K2 at K2_CELL_SHAPES: timed beside its bound, and its first heads
    held against the plain version (`tol_ratio` <= 1)."""
    lines = []
    for cell, (hb, seq, d, heads) in K2_CELL_SHAPES.items():
        q, k, v, do = (torch.randn((hb, seq, d), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, True, True)
        di = (do.float() * o.float()).sum(-1)
        dk, dv = torch.empty_like(q), torch.empty_like(q)
        ms = _cuda_ms(torch, lambda: fa.launch_bwd(
            q, k, v, do, lse, di, None, dk, dv, scale, True), 10)
        args = (*(t[:heads] for t in (q, k, v, do, lse, di)), scale, True)
        ref_dk, ref_dv = fa.flash_bwd_dkv_plain(*args)
        term_dk, term_dv = fa.rounding_terms_dkv(*args)
        err_dk = _elem_err(dk[:heads], ref_dk, "bfloat16", term_dk)
        err_dv = _elem_err(dv[:heads], ref_dv, "bfloat16", term_dv)
        err = {key: max(err_dk[key], err_dv[key]) for key in err_dk}
        ok = err["tol_ratio"] <= 1.0 and all(
            bool(torch.isfinite(t).all()) for t in (dk, dv))
        bound_ms, bound_by, flops = bwd_bounds(hb, seq, d, "bfloat16",
                                               True)["flash_bwd_dkv"]
        line = dict(kernel="flash_bwd_dkv", cell=cell, hb=hb, seq=seq, d=d,
                    dtype="bfloat16", causal=True, ms=ms, bound_ms=bound_ms,
                    bound_by=bound_by, **_speed(ms, bound_ms, flops),
                    checked_heads=heads, **err, ok=ok)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del q, k, v, do, o, lse, di, dk, dv, ref_dk, ref_dv, term_dk, term_dv
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"flash_bwd_dkv disagrees with its plain "
                                 f"version at {cell}'s shape: {line}")
    return lines


def time_dq_at_cells(torch, fa, dev, gen) -> list:
    """K3 at K3_CELL_SHAPES: timed beside its bound into bf16 dq (the
    training path's), and its first heads held against the plain version
    (`tol_ratio` <= 1). Also launched into f32 dq (the ring's instance),
    held to the same bar, as the ring's f32 gradients are: its sums are
    the bf16 instance's, so rounded to bf16 it must give that dq bit for
    bit; and the bf16 dq must be bit for bit the same on a second
    launch."""
    lines = []
    for cell, (hb, seq, d, dv, heads) in K3_CELL_SHAPES.items():
        q, k = (torch.randn((hb, seq, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        v, do = (torch.randn((hb, seq, dv), generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
        scale = d ** -0.5
        o, lse = fa.flash_attention_fwd(q, k, v, scale, True, True)
        di = (do.float() * o.float()).sum(-1)
        dq, again = torch.empty_like(q), torch.empty_like(q)
        dq32 = torch.empty(q.shape, dtype=torch.float32, device=dev)
        ms = _cuda_ms(torch, lambda: fa.launch_bwd(
            q, k, v, do, lse, di, dq, None, None, scale, True), 10)
        for out in (again, dq32):
            fa.launch_bwd(q, k, v, do, lse, di, out, None, None, scale, True)
        torch.cuda.synchronize()
        args = (*(t[:heads] for t in (q, k, v, do, lse, di)), scale, True)
        ref, term = fa.flash_bwd_dq_plain(*args), fa.rounding_terms_dq(*args)
        err = _elem_err(dq[:heads], ref, "bfloat16", term)
        err32 = _elem_err(dq32[:heads], ref, "bfloat16", term)
        repeats = torch.equal(dq, again)
        f32_rounds = torch.equal(dq32.to(torch.bfloat16), dq)
        ok = (err["tol_ratio"] <= 1.0 and err32["tol_ratio"] <= 1.0
              and repeats and f32_rounds and all(
                  bool(torch.isfinite(t).all()) for t in (dq, dq32)))
        bound_ms, bound_by, flops = latent_bounds(hb, seq, d,
                                                  dv)["flash_bwd_dq"]
        line = dict(kernel="flash_bwd_dq", cell=cell, hb=hb, seq=seq, d=d,
                    dv=dv, dtype="bfloat16", causal=True, ms=ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    **_speed(ms, bound_ms, flops), checked_heads=heads,
                    **err, f32_tol_ratio=err32["tol_ratio"],
                    bit_for_bit_again=repeats, f32_rounds_to_bf16=f32_rounds,
                    ok=ok)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del q, k, v, do, o, lse, di, dq, again, dq32, ref, term
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"flash_bwd_dq disagrees with its plain "
                                 f"version at {cell}'s shape: {line}")
    return lines


def xent_bounds(b: int, s: int, t: int, v: int):
    """Least time (ms) for xent_fwd and for xent_bwd on the card, both bound
    by bytes: the forward reads the T rows of bf16 logits once and writes
    two f32 values a row; the backward reads those rows, their lse and
    target, and writes the whole (B, S, V) bf16 gradient once."""
    rows = b * t
    fwd = rows * v * 2 + rows * (8 + 8)
    bwd = rows * v * 2 + rows * (4 + 8) + b * s * v * 2
    return {"xent_fwd": (*_bound(0, fwd, "bfloat16"), fwd),
            "xent_bwd": (*_bound(0, bwd, "bfloat16"), bwd)}


def xent_grad_err(torch, grad, ref, targets, g) -> dict:
    """max |d| and `tol_ratio` (held to <= 1) of the head's bf16 gradient
    against the plain version's, by the bar above; in blocks of rows, to
    keep the f32 copies small."""
    t = targets.shape[1]
    worst = max_abs = 0.0
    for i in range(0, grad.shape[0], 16):
        out, want = grad[i:i + 16].float(), ref[i:i + 16].float()
        diff = (out - want).abs()
        bar = GRAD_RTOL["bfloat16"] * want.abs() + XENT_GRAD_ATOL
        tg = targets[i:i + 16, :, None]
        bar[:, :t].scatter_add_(-1, tg, torch.full(
            tg.shape, XENT_TARGET_ATOL * abs(g.item()), device=bar.device))
        worst = max(worst, (diff / bar).max().item())
        max_abs = max(max_abs, diff.max().item())
    return dict(max_abs_err=max_abs, tol_ratio=worst)


def check_xent(torch, dev):
    """Phase 3 for the head's NLL pair: every shape against the plain
    version; times at switch-base-8's head shape. Returns the pair's JSON
    entry (launches filled later)."""
    import torch.nn.functional as F
    from tpu_device_plugin_torch.validator import xent
    gen = torch.Generator(dev).manual_seed(2)
    g = torch.tensor(0.37, device=dev)
    checks = []
    for b, s, t, v in XENT_SHAPES:
        logits = (4 * torch.randn((b, s, v), generator=gen, device=dev)
                  ).to(torch.bfloat16)
        targets = torch.randint(0, v, (b, s + 1), generator=gen,
                                device=dev)[:, 1:t + 1]
        lse, nll = xent.nll_rows(logits, targets)
        grad = xent.nll_grad(logits, targets, lse, g)
        loss = nll.sum()
        torch.cuda.synchronize()
        ref_lse, ref_nll = xent.nll_rows_plain(logits, targets)
        err_lse = (lse - ref_lse).abs().max().item()
        err_nll = (nll - ref_nll).abs().max().item()
        del ref_lse, ref_nll
        leaf = logits.detach().requires_grad_()
        ref = xent.nll_sum_plain(leaf, targets)
        ref_grad, = torch.autograd.grad(ref * g, leaf)
        err = xent_grad_err(torch, grad, ref_grad, targets, g)
        del ref_grad, leaf
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        zero_past_t = bool((grad[:, t:] == 0).all())
        ok = (err_lse <= NLL_ATOL and err_nll <= NLL_ATOL
              and loss_rel <= NLL_RTOL and err["tol_ratio"] <= 1.0
              and zero_past_t and bool(torch.isfinite(grad).all()))
        line = dict(kernel="xent", b=b, s=s, t=t, v=v,
                    lse_max_abs_err=err_lse, nll_max_abs_err=err_nll,
                    loss_rel_err=loss_rel, zero_past_t=zero_past_t, **err,
                    nll_atol=NLL_ATOL, nll_rtol=NLL_RTOL, ok=ok)
        print(json.dumps(line), flush=True)
        checks.append(line)
        if not ok:
            raise AssertionError(f"xent disagrees with its plain version: "
                                 f"{line}")
        del logits, targets, lse, nll, grad, ref
        torch.cuda.empty_cache()

    b, s, t, v = XENT_SHAPES[0]
    logits = (4 * torch.randn((b, s, v), generator=gen, device=dev)
              ).to(torch.bfloat16)
    targets = torch.randint(0, v, (b, s + 1), generator=gen,
                            device=dev)[:, 1:t + 1]
    lse, _ = xent.nll_rows(logits, targets)
    ms = {"xent_fwd": _cuda_ms(torch, lambda: xent.nll_rows(logits, targets),
                               20),
          "xent_bwd": _cuda_ms(torch, lambda: xent.nll_grad(logits, targets,
                                                            lse, g), 20)}
    leaf = logits.detach().requires_grad_()
    pair_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        xent.nll_sum(leaf, targets), leaf), 10)
    plain_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        xent.nll_sum_plain(leaf, targets), leaf), 3)
    torch.cuda.empty_cache()
    # yardstick: cross-entropy on the f32 logits of the T positions
    wide = logits.float()[:, :t].reshape(-1, v).requires_grad_()
    flat = targets.reshape(-1)
    library_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        F.cross_entropy(wide, flat, reduction="sum"), wide), 3)
    del wide, leaf, logits, lse
    torch.cuda.empty_cache()
    bounds = xent_bounds(b, s, t, v)
    bound_ms = sum(bounds[k][0] for k in bounds)
    nbytes = sum(bounds[k][2] for k in bounds)
    line = dict(kernel="xent", b=b, s=s, t=t, v=v, ms=pair_ms,
                fwd_ms=ms["xent_fwd"], bwd_ms=ms["xent_bwd"],
                fwd_bound_ms=bounds["xent_fwd"][0],
                bwd_bound_ms=bounds["xent_bwd"][0], bound_ms=bound_ms,
                bound_by="bytes", bound_share=bound_ms / pair_ms,
                tb_per_s=nbytes / pair_ms * 1e-9, plain_ms=plain_ms,
                library_ms=library_ms)
    print(json.dumps(line), flush=True)
    return {
        "name": "xent",
        "route": "cuda",
        "source": "tpu_device_plugin_torch/validator/csrc/xent.cu",
        "replaces": "none (the training loss's log-softmax and gather, "
                    "tpu_device_plugin/validator/workload.py:328, left to XLA)",
        "launches": 0,
        **{key: checks[0][key] for key in ("lse_max_abs_err",
                                           "nll_max_abs_err", "loss_rel_err",
                                           "max_abs_err", "tol_ratio")},
        **{key: line[key] for key in ("ms", "fwd_ms", "bwd_ms", "bound_ms",
                                      "bound_by", "bound_share", "plain_ms",
                                      "library_ms")},
        "library_is": "F.cross_entropy forward and backward on the f32 "
                      "logits of the T positions",
        "ok": all(c["ok"] for c in checks),
        "checks": len(checks),
    }


def conv_bounds(b: int, s: int, d: int):
    """Least time (ms) for conv_fwd and for conv_bwd on the card, both bound
    by bytes: the forward reads bch (b, s, 3d) once and writes y (b, s, d)
    once; the backward reads bch and dy once and writes dbch once (the taps
    and their gradient, K d floats, left out)."""
    fwd = b * s * (3 * d + d) * 2
    bwd = b * s * (3 * d + d + 3 * d) * 2
    return {"conv_fwd": (*_bound(0, fwd, "bfloat16"), fwd),
            "conv_bwd": (*_bound(0, bwd, "bfloat16"), bwd)}


def _conv_library(torch, bch, w):
    """The gated convolution through `F.conv1d(groups=d)` (bf16 taps): the
    yardstick the port never calls."""
    import torch.nn.functional as F
    (_, s, d3), taps = bch.shape, w.shape[0]
    gate_b, gate_c, h = bch.chunk(3, -1)
    mixed = F.conv1d((gate_b * h).transpose(1, 2),
                     w.t()[:, None].to(torch.bfloat16), padding=taps - 1,
                     groups=d3 // 3)[..., :s].transpose(1, 2)
    return gate_c * mixed


def _dw_exact(torch, bch, w, dy):
    """Each tap's gradient as the exact (f64) sum of the bf16 products
    bf16(dy C)[t + K-1-j] bf16(B h)[t] that the kernels and the plain
    version both sum in f32, and the sum of their absolute values."""
    s, taps = bch.shape[1], w.shape[0]
    gate_b, gate_c, h = bch.chunk(3, -1)
    u, dmixed = gate_b * h, dy * gate_c
    exact, mag = [], []
    for j in range(taps):
        shift = taps - 1 - j
        terms = (dmixed[:, shift:] * u[:, :s - shift]).double()
        exact.append(terms.sum((0, 1)))
        mag.append(terms.abs().sum((0, 1)))
        del terms
    return torch.stack(exact), torch.stack(mag)


def check_conv(torch, dev):
    """Phase 3 for the short convolution's pair: every shape against the
    plain version; times at LFM2's shape. Returns the pair's JSON entry."""
    from tpu_device_plugin_torch.validator import short_conv
    gen = torch.Generator(dev).manual_seed(3)

    def inputs(b, s, d, taps):
        bch = torch.randn((b, s, 3 * d), generator=gen, device=dev
                          ).to(torch.bfloat16)
        w = torch.randn((taps, d), generator=gen, device=dev) * taps ** -0.5
        dy = torch.randn((b, s, d), generator=gen, device=dev
                         ).to(torch.bfloat16)
        return bch, w, dy

    def plain(bch, w, dy):
        leaf = bch.detach().requires_grad_()
        wl = w.detach().requires_grad_()
        y = short_conv.gated_conv_plain(leaf, wl)
        y.backward(dy)
        return y.detach(), leaf.grad, wl.grad

    checks = []
    for b, s, d, taps in CONV_SHAPES:
        bch, w, dy = inputs(b, s, d, taps)
        y = short_conv.conv_fwd(bch, w)
        dbch, dw = short_conv.conv_bwd(bch, w, dy)
        dbch2, dw2 = short_conv.conv_bwd(bch, w, dy)
        torch.cuda.synchronize()
        ref_y, ref_dbch, ref_dw = plain(bch, w, dy)
        mag = ref_y.float().abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ulp_ratio = ((y.float() - ref_y.float()).abs() / ulp).max().item()
        del mag, ulp
        exact, mag = _dw_exact(torch, bch, w, dy)
        bar = (short_conv.dw_sum_depth(b, s) * 2 ** -24 * mag).clamp(
            min=1e-300)
        dw_ratio = ((dw.double() - exact).abs() / bar).max().item()
        plain_dw_ratio = ((ref_dw.double() - exact).abs() / bar).max().item()
        del exact, mag, bar
        err = _elem_err(dbch, ref_dbch, "bfloat16")
        repeat_equal = bool(torch.equal(dbch, dbch2) and torch.equal(dw, dw2))
        ok = (ulp_ratio <= 1.0 and err["tol_ratio"] <= 1.0 and dw_ratio <= 1.0
              and repeat_equal and bool(torch.isfinite(dbch).all()))
        line = dict(kernel="short_conv", b=b, s=s, d=d, taps=taps,
                    ulp_ratio=ulp_ratio,
                    y_equal_share=(y == ref_y).float().mean().item(),
                    dbch_equal_share=(dbch == ref_dbch).float().mean().item(),
                    **err, dw_ratio=dw_ratio, plain_dw_ratio=plain_dw_ratio,
                    repeat_equal=repeat_equal,
                    ok=ok)
        print(json.dumps(line), flush=True)
        checks.append(line)
        if not ok:
            raise AssertionError(f"short_conv disagrees with its plain "
                                 f"version: {line}")
        del bch, w, dy, y, dbch, dw, dbch2, dw2, ref_y, ref_dbch, ref_dw
        torch.cuda.empty_cache()

    b, s, d, taps = CONV_SHAPES[0]
    bch, w, dy = inputs(b, s, d, taps)
    ms = {"conv_fwd": _cuda_ms(torch, lambda: short_conv.conv_fwd(bch, w),
                               50),
          "conv_bwd": _cuda_ms(torch, lambda: short_conv.conv_bwd(bch, w, dy),
                               50)}
    leaf = bch.detach().requires_grad_()
    wl = w.detach().requires_grad_()
    pair_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        short_conv.gated_conv(leaf, wl), (leaf, wl), dy), 20)
    plain_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        short_conv.gated_conv_plain(leaf, wl), (leaf, wl), dy), 10)
    library_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        _conv_library(torch, leaf, wl), (leaf, wl), dy), 10)
    del bch, w, dy, leaf, wl
    torch.cuda.empty_cache()
    bounds = conv_bounds(b, s, d)
    bound_ms = sum(bounds[k][0] for k in bounds)
    nbytes = sum(bounds[k][2] for k in bounds)
    kernel_ms = ms["conv_fwd"] + ms["conv_bwd"]
    # the kernels' own time: the pair through autograd (`pair_ms`) adds the
    # host's time to build and run the graph, which exceeds the card's here
    line = dict(kernel="short_conv", b=b, s=s, d=d, taps=taps, ms=kernel_ms,
                fwd_ms=ms["conv_fwd"], bwd_ms=ms["conv_bwd"],
                fwd_bound_ms=bounds["conv_fwd"][0],
                bwd_bound_ms=bounds["conv_bwd"][0],
                fwd_bound_share=bounds["conv_fwd"][0] / ms["conv_fwd"],
                bwd_bound_share=bounds["conv_bwd"][0] / ms["conv_bwd"],
                bound_ms=bound_ms, bound_by="bytes",
                bound_share=bound_ms / kernel_ms,
                tb_per_s=nbytes / kernel_ms * 1e-9, pair_ms=pair_ms,
                plain_ms=plain_ms, library_ms=library_ms)
    print(json.dumps(line), flush=True)
    return {
        "name": "short_conv",
        "route": "cuda",
        "source": "tpu_device_plugin_torch/validator/csrc/short_conv.cu",
        "replaces": "none (LFM2's gated short convolution; the JAX package "
                    "has none)",
        **{key: checks[0][key] for key in ("ulp_ratio", "max_abs_err",
                                           "tol_ratio", "dw_ratio")},
        **{key: line[key] for key in ("ms", "fwd_ms", "bwd_ms", "bound_ms",
                                      "fwd_bound_share", "bwd_bound_share",
                                      "bound_by", "bound_share", "pair_ms",
                                      "plain_ms", "library_ms")},
        "library_is": "F.conv1d(groups=d) on bf16 taps with the two gates, "
                      "forward and backward",
        "ok": all(c["ok"] for c in checks),
        "checks": len(checks),
    }


def ssd_bounds(b: int, s: int, heads: int, p: int, n: int, groups: int,
               chunk: int = 256):
    """Least time (ms) for S1's forward and backward, the scan's work as
    the benchmark counts it (`ssd_work` of granite-4.0-h-small's
    definition): the chunked algorithm's products at the published chunk,
    x, dt, B, C read and y written once; the backward twice the products,
    the inputs read and their gradients written once, dy read."""
    t = b * s
    flops = (2 * t * chunk * n * groups
             + heads * (2 * t * chunk * p + 4 * t * p * n))
    inputs = t * (2 * heads * p + 4 * heads + 2 * 2 * groups * n)
    y = 2 * t * heads * p
    return {"ssd_fwd": (*_bound(flops, inputs + y, "bfloat16"), flops),
            "ssd_bwd": (*_bound(2 * flops, 2 * inputs + y, "bfloat16"),
                        2 * flops)}


def _ssd_inputs(torch, b, s, heads, p, n, groups, dev, seed=4):
    """x, dt, a, B, C, D as the Mamba mixer passes them (x, B, C views of
    one xBC row), and dy."""
    import torch.nn.functional as F
    gen = torch.Generator(dev).manual_seed(seed)
    width = heads * p + 2 * groups * n
    xbc = torch.randn((b, s, width), generator=gen, device=dev
                      ).to(torch.bfloat16)
    x, B, C = xbc.split([heads * p, groups * n, groups * n], -1)
    dt = F.softplus(torch.randn((b, s, heads), generator=gen, device=dev)
                    - 4.6)
    a = -torch.exp(1.386 + 0.5 * torch.randn(heads, generator=gen,
                                              device=dev))
    D = 1 + 0.1 * torch.randn(heads, generator=gen, device=dev)
    dy = torch.randn((b, s, heads, p), generator=gen, device=dev
                     ).to(torch.bfloat16)
    return (x.view(b, s, heads, p), dt, a, B.view(b, s, groups, n),
            C.view(b, s, groups, n), D), dy


def _ssd_plain_grads(torch, ssd, inputs, dy, heads_at_once):
    """The plain version's y and every input's gradient, the heads taken
    SSD_PLAIN_HEADS at a time, dB and dC summed over them in f32."""
    x, dt, a, B, C, D = inputs
    heads, per_group = x.shape[2], x.shape[2] // B.shape[2]
    ys, dxs, ddts, das, dds = [], [], [], [], []
    dB = torch.zeros_like(B, dtype=torch.float32)
    dC = torch.zeros_like(C, dtype=torch.float32)
    for h0 in range(0, heads, heads_at_once):
        hs = slice(h0, h0 + heads_at_once)
        g0, g1 = h0 // per_group, (h0 + heads_at_once - 1) // per_group + 1
        leaves = [t.detach().float().requires_grad_() for t in (
            x[:, :, hs], dt[..., hs], a[hs], B[:, :, g0:g1], C[:, :, g0:g1],
            D[hs])]
        y = ssd.ssd_plain(leaves[0].bfloat16(), leaves[1], leaves[2],
                          leaves[3].bfloat16(), leaves[4].bfloat16(),
                          leaves[5])
        y.backward(dy[:, :, hs])
        ys.append(y.detach())
        dxs.append(leaves[0].grad.bfloat16())
        ddts.append(leaves[1].grad)
        das.append(leaves[2].grad)
        dds.append(leaves[5].grad)
        dB[:, :, g0:g1] += leaves[3].grad
        dC[:, :, g0:g1] += leaves[4].grad
        del y, leaves
    return (torch.cat(ys, 2), torch.cat(dxs, 2), torch.cat(ddts, -1),
            torch.cat(das), dB, dC, torch.cat(dds))


def _rel(out, ref) -> float:
    return ((out.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-30)).item()


def check_ssd(torch, fa, dev):
    """Phase 3 for S1: every output at the cell's one layer (SSD_SHAPE)
    and at small ragged shapes against the plain version (SSD_TOL), bit
    for bit the same on a second run; times at the cell's. Returns the
    pair's JSON entry."""
    from tpu_device_plugin_torch.validator import ssd
    shapes = [SSD_SHAPE, (1, 1, 4, 64, 128, 2), (2, 200, 4, 64, 128, 1),
              (1, 1000, 8, 64, 128, 2)]
    checks = []
    for shape in shapes:
        inputs, dy = _ssd_inputs(torch, *shape, dev)
        y, states = ssd.ssd_fwd(*inputs, True)
        grads = ssd.ssd_bwd(*inputs, states, dy)
        again = ssd.ssd_bwd(*inputs, states, dy)
        torch.cuda.synchronize()
        repeat_equal = all(torch.equal(u, v) for u, v in zip(grads, again))
        del again, states
        ref = _ssd_plain_grads(torch, ssd, inputs, dy,
                               min(SSD_PLAIN_HEADS, shape[2]))
        errs = {name: _rel(out, r) for name, out, r in zip(
            ("y", "dx", "ddt", "da", "dB", "dC", "dD"), (y, *grads), ref)}
        ok = repeat_equal and all(errs[k] <= SSD_TOL[k] for k in errs) and \
            all(bool(torch.isfinite(t.float()).all()) for t in (y, *grads))
        line = dict(kernel="ssd", shape=shape, max_rel_err=errs,
                    tol=SSD_TOL, repeat_equal=repeat_equal, ok=ok)
        print(json.dumps(line), flush=True)
        checks.append(line)
        if not ok:
            raise AssertionError(f"S1 disagrees with its plain version: "
                                 f"{line}")
        del inputs, dy, y, grads, ref
        torch.cuda.empty_cache()

    inputs, dy = _ssd_inputs(torch, *SSD_SHAPE, dev)
    _, states = ssd.ssd_fwd(*inputs, True)
    ms = {"ssd_fwd": _cuda_ms(torch, lambda: ssd.ssd_fwd(*inputs, False), 10),
          "ssd_fwd_saving": _cuda_ms(torch, lambda: ssd.ssd_fwd(*inputs,
                                                                True), 10),
          "ssd_bwd": _cuda_ms(torch, lambda: ssd.ssd_bwd(*inputs, states,
                                                         dy), 10)}
    del states
    plain_ms = _cuda_ms(torch, lambda: _ssd_plain_grads(
        torch, ssd, inputs, dy, SSD_PLAIN_HEADS), 1)
    del inputs, dy
    torch.cuda.empty_cache()
    bounds = ssd_bounds(*SSD_SHAPE)
    bound_ms = bounds["ssd_fwd"][0] + bounds["ssd_bwd"][0]
    kernel_ms = ms["ssd_fwd_saving"] + ms["ssd_bwd"]
    line = dict(kernel="ssd", shape=SSD_SHAPE, ms=kernel_ms,
                fwd_ms=ms["ssd_fwd"], fwd_saving_ms=ms["ssd_fwd_saving"],
                bwd_ms=ms["ssd_bwd"], fwd_bound_ms=bounds["ssd_fwd"][0],
                bwd_bound_ms=bounds["ssd_bwd"][0],
                fwd_bound_by=bounds["ssd_fwd"][1],
                bwd_bound_by=bounds["ssd_bwd"][1], bound_ms=bound_ms,
                bound_share=bound_ms / kernel_ms,
                tflops=(bounds["ssd_fwd"][2] + bounds["ssd_bwd"][2])
                / kernel_ms * 1e-9, plain_ms=plain_ms)
    print(json.dumps(line), flush=True)
    return {"name": "ssd", "route": "cuda",
            "source": "tpu_device_plugin_torch/validator/csrc/ssd.cu",
            "replaces": "none (Mamba-2's chunked scan; the JAX package has "
                        "no state-space layer)",
            "max_rel_err": checks[0]["max_rel_err"],
            **{k: line[k] for k in ("ms", "fwd_ms", "fwd_saving_ms",
                                    "bwd_ms", "bound_ms", "bound_share",
                                    "tflops", "plain_ms")},
            "ok": all(c["ok"] for c in checks), "checks": len(checks)}


def _ulp_ratio(torch, out, ref, extra) -> float:
    """The largest |out - ref| over one bf16 ulp of |ref| (of the least
    normal bf16 value where ref is smaller) plus `extra`."""
    ref = ref.float()
    mag = ref.abs().clamp(min=torch.finfo(torch.bfloat16).tiny)
    bar = torch.exp2(torch.floor(torch.log2(mag)) - 7) + extra
    return ((out.float() - ref).abs() / bar).max().item()


def _conv_silu_magnitudes(torch, x, w, bias, dy):
    """For the ungated convolution: the sum of |w_j x_j| and |bias| of each
    output, and of |g w_j| of each input's gradient, |g| = |dy| (|silu'(sum)|
    + the sum's magnitude above), 0 past the sequence."""
    s, taps = x.shape[1], w.shape[0]

    def causal(values, weights):
        acc = values * weights[taps - 1]
        for j in range(taps - 1):
            shift = taps - 1 - j
            if shift < s:
                acc[:, shift:] += values[:, :s - shift] * weights[j]
        return acc

    xf = x.float()
    total = causal(xf, w) + bias
    sig = torch.sigmoid(total)
    sum_mag = causal(xf.abs(), w.abs()) + bias.abs()
    # |g| and the error that the sum's own carries into g (|silu''| < 1)
    g = dy.float().abs() * ((sig * (1 + total * (1 - sig))).abs() + sum_mag)
    del total, sig
    grad_mag = g * w[taps - 1].abs()      # dx[t] = sum_j g[t+K-1-j] w_j
    for j in range(taps - 1):
        shift = taps - 1 - j
        if shift < s:
            grad_mag[:, :s - shift] += g[:, shift:] * w[j].abs()
    return sum_mag, grad_mag


def check_conv_silu(torch, dev):
    """Phase 3 for C1's ungated mode: every shape (CONV_SILU_SHAPES, x read
    in place in wider rows) against the plain version, bit for bit on a
    second run; times at Granite's. Returns the pair's JSON entry."""
    import torch.nn.functional as F
    from tpu_device_plugin_torch.validator import short_conv
    gen = torch.Generator(dev).manual_seed(5)

    def inputs(b, s, d, stride):
        rows = torch.randn((b, s, stride), generator=gen, device=dev
                           ).to(torch.bfloat16)
        x = rows[..., stride - d:] if stride > d else rows
        w = 0.5 * torch.randn((4, d), generator=gen, device=dev)
        bias = 0.1 * torch.randn((d,), generator=gen, device=dev)
        dy = torch.randn((b, s, d), generator=gen, device=dev
                         ).to(torch.bfloat16)
        return x, w, bias, dy

    def plain(x, w, bias, dy):
        leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
        y = short_conv.conv_silu_plain(*leaves)
        y.backward(dy)
        return y.detach(), *(t.grad for t in leaves)

    checks = []
    for shape in CONV_SILU_SHAPES:
        x, w, bias, dy = inputs(*shape)
        y = short_conv.conv_silu_fwd(x, w, bias)
        grads = short_conv.conv_silu_bwd(x, w, bias, dy)
        again = short_conv.conv_silu_bwd(x, w, bias, dy)
        torch.cuda.synchronize()
        repeat_equal = all(torch.equal(u, v) for u, v in zip(grads, again))
        ref_y, ref_dx, ref_dw, ref_db = plain(x, w, bias, dy)
        sum_mag, grad_mag = _conv_silu_magnitudes(torch, x, w, bias, dy)
        y_ratio = _ulp_ratio(torch, y, ref_y, CONV_SILU_SUM_TOL * sum_mag)
        dx_ratio = _ulp_ratio(torch, grads[0], ref_dx,
                              CONV_SILU_SUM_TOL * grad_mag)
        dw_rel, db_rel = _rel(grads[1], ref_dw), _rel(grads[2], ref_db)
        ok = (y_ratio <= 1.0 and dx_ratio <= 1.0 and repeat_equal
              and max(dw_rel, db_rel) <= CONV_SILU_DW_TOL)
        line = dict(kernel="conv_silu", shape=shape, y_ratio=y_ratio,
                    dx_ratio=dx_ratio,
                    y_ulp_ratio=_ulp_ratio(torch, y, ref_y, 0),
                    dw_rel=dw_rel, db_rel=db_rel,
                    repeat_equal=repeat_equal, ok=ok)
        print(json.dumps(line), flush=True)
        checks.append(line)
        if not ok:
            raise AssertionError(f"the ungated conv disagrees with its plain "
                                 f"version: {line}")
        del x, w, bias, dy, y, grads, again, ref_y, ref_dx, sum_mag, grad_mag
        torch.cuda.empty_cache()

    b, s, d, _ = CONV_SILU_SHAPES[0]
    x, w, bias, dy = inputs(*CONV_SILU_SHAPES[0])
    ms = {"fwd": _cuda_ms(torch, lambda: short_conv.conv_silu_fwd(x, w, bias),
                          50),
          "bwd": _cuda_ms(torch, lambda: short_conv.conv_silu_bwd(x, w, bias,
                                                                  dy), 50)}
    leaves = [t.detach().requires_grad_() for t in (x, w, bias)]
    plain_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        short_conv.conv_silu_plain(*leaves), leaves, dy), 10)

    def library(x, w, bias):
        return F.silu(F.conv1d(x.transpose(1, 2), w.t()[:, None].to(x.dtype),
                               bias.to(x.dtype), padding=3, groups=d)
                      [..., :s].transpose(1, 2))

    library_ms = _cuda_ms(torch, lambda: torch.autograd.grad(
        library(*leaves), leaves, dy), 10)
    del x, w, bias, dy, leaves
    torch.cuda.empty_cache()
    # bytes: x read and y written forward; x, dy read and dx written back
    fwd_bytes, bwd_bytes = 2 * b * s * d * 2, 3 * b * s * d * 2
    bound_ms = (_bound(0, fwd_bytes, "bfloat16")[0]
                + _bound(0, bwd_bytes, "bfloat16")[0])
    kernel_ms = ms["fwd"] + ms["bwd"]
    line = dict(kernel="conv_silu", b=b, s=s, d=d, ms=kernel_ms,
                fwd_ms=ms["fwd"], bwd_ms=ms["bwd"], bound_ms=bound_ms,
                bound_by="bytes", bound_share=bound_ms / kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms)
    print(json.dumps(line), flush=True)
    return {"name": "conv_silu", "route": "cuda",
            "source": "tpu_device_plugin_torch/validator/csrc/conv_silu.cu",
            "replaces": "none (Mamba-2's causal convolution with its bias "
                        "and SiLU)",
            **{k: line[k] for k in ("ms", "fwd_ms", "bwd_ms", "bound_ms",
                                    "bound_share", "plain_ms",
                                    "library_ms")},
            "library_is": "F.conv1d(groups=D) on bf16 taps and bias, then "
                          "SiLU, forward and backward",
            "ok": all(c["ok"] for c in checks), "checks": len(checks)}


def check_granite_block(torch, fa, dev) -> dict:
    """Phase 7 for Granite-4.0-H's block (GRANITE_BLOCK) through
    `workload.sgd_step` and `workload.forward`, each with the launch counts
    set to 0 just before it: a step launches S1 and C1's ungated pair once
    a Mamba layer and counts b s heads `mamba.scan_rows`, K1 twice (remat)
    and K2, K3 once the attention layer; a forward the forwards alone.
    Then one step's loss and gradients against the same step with the
    plain scan and convolution in the kernels' place. Returns {path:
    launches}."""
    from tpu_device_plugin_torch.validator import (short_conv, ssd, tracing,
                                                   workload)
    cfg = workload.ModelConfig(**GRANITE_BLOCK)
    mamba = cfg.layer_types.count("mamba")
    attn = cfg.n_layers - mamba
    step, params, momentum, tokens = workload.build_workload(
        cfg, seed=0, attention="flash", device=dev)

    def counted():
        return {**ssd.launches, **short_conv.ungated_launches,
                **fa.launches}

    def zero():
        _reset(fa)
        for counts in (ssd.launches, short_conv.ungated_launches):
            counts.update(dict.fromkeys(counts, 0))

    zero()
    with tracing.recording() as rec:
        loss = step(params, momentum, tokens)[2].item()
    launches = {"granite_train": counted()}
    expected = {"ssd_fwd": 2 * mamba, "ssd_bwd": mamba,
                "conv_silu_fwd": 2 * mamba, "conv_silu_bwd": mamba,
                "flash_fwd": 2 * attn, "flash_bwd_dkv": attn,
                "flash_bwd_dq": attn}
    line = dict(check="Granite block through sgd_step, counted", loss=loss,
                launches=launches["granite_train"],
                scan_rows=rec.counts.get("mamba.scan_rows"))
    print(json.dumps(line), flush=True)
    if (launches["granite_train"] != expected or not math.isfinite(loss)
            or line["scan_rows"] != mamba * cfg.batch * cfg.seq_len
            * cfg.mamba_heads):
        raise AssertionError(f"the Granite block's step went another way: "
                             f"{line}")
    zero()
    with torch.no_grad():
        finite = bool(torch.isfinite(workload.forward(
            params, tokens, cfg, "flash")).all())
    launches["granite_infer"] = counted()
    if not finite or launches["granite_infer"] != {
            "ssd_fwd": mamba, "ssd_bwd": 0, "conv_silu_fwd": mamba,
            "conv_silu_bwd": 0, "flash_fwd": attn, "flash_bwd_dkv": 0,
            "flash_bwd_dq": 0}:
        raise AssertionError(f"the Granite forward launched "
                             f"{launches['granite_infer']}; finite {finite}")
    torch.cuda.empty_cache()
    loss, grads = workload.value_and_grad(params, tokens, cfg, "flash")
    with mock.patch.object(ssd, "ssd", ssd.ssd_plain), \
            mock.patch.object(short_conv, "conv_silu",
                              short_conv.conv_silu_plain):
        ref_loss, ref = workload.value_and_grad(params, tokens, cfg, "flash")
    # each leaf's |g - ref| over the larger of its reference norm and the
    # median leaf's, as the benchmark's grad_gap: the two steps route a few
    # near-tied tokens to other experts, so an expert leaf reads far off by
    # max |d| / max |ref| alone (w2e 6.6% on an H100, its norm 1.4%)
    named = workload._named_leaves(grads)
    norms = {k: r.norm().item() for (k, _), r in zip(
        named, workload._leaves(ref))}
    floor = sorted(norms.values())[len(norms) // 2]
    gaps = {k: (g - r).norm().item() / max(norms[k], floor, 1e-30)
            for (k, g), r in zip(named, workload._leaves(ref))}
    raw = {k: _rel(g, r) for (k, g), r in zip(named, workload._leaves(ref))}
    worst = max(gaps.values())
    line = dict(check="Granite block step: S1 and C1 vs their plain versions",
                loss_diff=abs(loss.item() - ref_loss.item()),
                max_grad_gap=worst, grad_gap_tol=STEP_GRAD_REL_TOL,
                loss_tol=STEP_LOSS_TOL,
                widest=sorted(gaps.items(), key=lambda kv: -kv[1])[:4],
                widest_max_rel=sorted(raw.items(), key=lambda kv: -kv[1])[:4])
    print(json.dumps(line), flush=True)
    if worst > STEP_GRAD_REL_TOL or line["loss_diff"] > STEP_LOSS_TOL:
        raise AssertionError(f"the Granite block's kernel step disagrees "
                             f"with the plain one: {line}")
    del params, momentum, tokens, grads, ref, step
    return launches


def _reset(fa):
    from tpu_device_plugin_torch.validator import short_conv, xent
    for counts in (fa.launches, xent.launches, short_conv.launches):
        for name in counts:
            counts[name] = 0


class _Router:
    """Stands in for `workload._route`: records each call's router logits
    and, with `pinned` experts per call, routes to those (with its own
    gates); else to its own argmax, as `_route` does."""

    def __init__(self, torch, pinned=None):
        self.torch, self.pinned, self.logits, self.top1 = torch, pinned, [], []

    def __call__(self, xt, wr):
        logits = xt.float() @ wr.to(self.torch.bfloat16).float()
        gates = self.torch.softmax(logits, dim=-1)
        top1 = gates.argmax(dim=-1)
        self.logits.append(logits.detach())
        self.top1.append(top1)
        if self.pinned is not None:
            top1 = self.pinned[len(self.top1) - 1]
        return gates.gather(-1, top1[:, None])[:, 0], top1


def compare_moe_steps(torch, fa, cfg, dev) -> dict:
    """One MoE training step's loss and gradients through the kernels and
    through their plain versions on the same weights and tokens, the plain
    step on the kernel step's routes; and the plain step's own routes
    against the kernel step's (every disagreement a tie within the
    layer's largest router-logit difference)."""
    from tpu_device_plugin_torch.validator import workload, xent
    _, params, _, tokens = workload.build_workload(cfg, seed=0,
                                                   attention="flash",
                                                   device=dev)
    _reset(fa)
    kernel_routes = _Router(torch)
    with mock.patch.object(workload, "_route", kernel_routes):
        loss, grads = workload.value_and_grad(params, tokens, cfg, "flash")
    expected = dict.fromkeys(fa.launches, cfg.n_layers)
    if fa.launches != expected:
        raise AssertionError(f"kernel step launched {fa.launches}, "
                             f"expected {expected}")
    plain_routes = _Router(torch, pinned=kernel_routes.top1)
    with mock.patch.object(fa, "flash_attention_fwd", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_attention_bwd",
                              fa.flash_attention_bwd_plain), \
            mock.patch.object(xent, "nll_sum", xent.nll_sum_plain), \
            mock.patch.object(workload, "_route", plain_routes):
        ref_loss, ref = workload.value_and_grad(params, tokens, cfg, "flash")
    if fa.launches != expected:
        raise AssertionError(f"plain step launched a kernel: {fa.launches}")
    rel = {}
    for (key, g), r in zip(workload._named_leaves(grads),
                           workload._leaves(ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient for {key}")
        rel[key] = ((g - r).abs().max() / r.abs().max()).item()
    agree, untied, max_dl = [], 0, 0.0
    for lk, lp, tk, tp in zip(kernel_routes.logits, plain_routes.logits,
                              kernel_routes.top1, plain_routes.top1):
        dl = (lk - lp).abs().max()
        max_dl = max(max_dl, dl.item())
        agree.append(int((tk == tp).sum()))
        flip = tk != tp
        gap = (lk.gather(1, tk[:, None]) - lk.gather(1, tp[:, None])).abs()[:, 0]
        untied += int((flip & (gap > dl)).sum())
    tokens_routed = len(agree) * cfg.batch * cfg.seq_len
    del grads, ref, params
    torch.cuda.empty_cache()
    return dict(loss=loss.item(), plain_loss=ref_loss.item(),
                loss_diff=abs(loss.item() - ref_loss.item()),
                max_grad_rel=max(rel.values()), grad_rel=rel,
                routes_agreeing_per_layer=agree,
                route_agreement=sum(agree) / tokens_routed,
                route_flips_not_ties=untied, max_router_logit_diff=max_dl)


def check_moe_dispatch(torch, fa, cfg, dev) -> dict:
    """The scatter dispatch (`workload._moe`) against its one-hot plain
    version (`_moe_onehot`) on layer 0's MoE input at the mfu width, bit
    for bit, and the time of each (CUDA events)."""
    from tpu_device_plugin_torch.validator import workload
    _, params, tokens = workload.build_infer(cfg, seed=0, attention="flash",
                                             device=dev)
    layer = {k: v[0] for k, v in params["layers"].items()}
    with torch.no_grad():
        x = workload._bf16(params["embed"])[tokens]
        x = x + workload._attention(workload._rms_norm(x), layer, cfg, "flash")
        x = workload._rms_norm(x)
        out = workload._moe(x, layer, cfg)
        ref = workload._moe_onehot(x, layer, cfg)
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, ref))
        dropped = int((ref == 0).all(-1).sum())
        ms = _cuda_ms(torch, lambda: workload._moe(x, layer, cfg), 10)
        onehot_ms = _cuda_ms(torch, lambda: workload._moe_onehot(x, layer,
                                                                 cfg), 3)
    line = dict(check="MoE dispatch: scatter vs one-hot, bit for bit",
                tokens=cfg.batch * cfg.seq_len, d=cfg.d_model,
                n_experts=cfg.n_experts,
                capacity=workload._capacity(cfg.batch * cfg.seq_len,
                                            cfg.n_experts,
                                            cfg.capacity_factor),
                dropped_tokens=dropped, equal=equal,
                finite=bool(torch.isfinite(out).all()),
                moe_ms=ms, onehot_ms=onehot_ms, ok=equal)
    del params, out, ref, x
    torch.cuda.empty_cache()
    return line


def check_moe(torch, fa, cfg, dev):
    """Phase 6: the MoE training and serving paths through validate_slice,
    each counted from 0, then the dispatch and the step comparison.
    Returns {path: launches}."""
    from tpu_device_plugin_torch.validator.probe import validate_slice
    launches = {}
    _reset(fa)
    report = validate_slice(cfg=cfg, steps=3, attention="flash", mode="train",
                            device="cuda")
    launches["moe_train"] = dict(fa.launches)
    print(report.to_json(), flush=True)
    if not report.ok or not report.loss_end < report.loss_start:
        raise AssertionError(f"validate_slice(mfu MoE, train) not ok: "
                             f"{report.error}")
    expected = dict.fromkeys(fa.launches, cfg.n_layers * report.steps)
    if report.steps <= 0 or launches["moe_train"] != expected:
        raise AssertionError(
            f"MoE training launches {launches['moe_train']} in "
            f"{report.steps} steps; expected {cfg.n_layers} of each kernel "
            "per step")
    torch.cuda.empty_cache()

    _reset(fa)
    report = validate_slice(cfg=cfg, steps=5, attention="flash", mode="infer",
                            device="cuda")
    launches["moe_infer"] = dict(fa.launches)
    print(report.to_json(), flush=True)
    if not report.ok:
        raise AssertionError(f"validate_slice(mfu MoE, infer) not ok: "
                             f"{report.error}")
    expected = {"flash_fwd": cfg.n_layers * report.forwards,
                "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    if report.forwards <= 0 or launches["moe_infer"] != expected:
        raise AssertionError(
            f"MoE serving launches {launches['moe_infer']} in "
            f"{report.forwards} forwards; expected {expected}")
    print(json.dumps({"launches": launches}), flush=True)
    torch.cuda.empty_cache()

    line = check_moe_dispatch(torch, fa, cfg, dev)
    print(json.dumps(line), flush=True)
    if not (line["ok"] and line["finite"]):
        raise AssertionError(f"MoE dispatch disagrees with the one-hot "
                             f"form: {line}")

    line = compare_moe_steps(torch, fa, cfg, dev)
    line.update(check="mfu MoE training step: kernels vs plain versions, "
                "plain on the kernel step's routes",
                grad_rel_tol=STEP_GRAD_REL_TOL, loss_tol=STEP_LOSS_TOL,
                route_agree_min=MOE_ROUTE_AGREE_MIN)
    print(json.dumps(line), flush=True)
    if (line["max_grad_rel"] > STEP_GRAD_REL_TOL
            or line["loss_diff"] > STEP_LOSS_TOL
            or line["route_agreement"] < MOE_ROUTE_AGREE_MIN
            or line["route_flips_not_ties"]):
        raise AssertionError("the MoE training step through the kernels "
                             "disagrees with the plain versions")
    return launches


def check_hybrid(torch, fa, dev) -> dict:
    """Phase 7: LFM2's hybrid block (HYBRID) through `workload.sgd_step`
    and `workload.forward`, each with the launch counts set to 0 just
    before it: a step launches conv_fwd and conv_bwd once a conv layer, K1,
    K2 and K3 once an attention layer and the head's pair once, and counts
    b s `conv.fused_rows` a conv layer; a forward launches conv_fwd and K1
    alone. Then one step's loss and gradients against the same step with
    `gated_conv_plain` in `gated_conv`'s place. Returns {path: conv
    launches}."""
    from tpu_device_plugin_torch.validator import (short_conv, tracing,
                                                   workload, xent)
    cfg = workload.ModelConfig(**HYBRID)
    conv = cfg.layer_types.count("conv")
    attn = cfg.n_layers - conv
    step, params, momentum, tokens = workload.build_workload(
        cfg, seed=0, attention="flash", device=dev)
    _reset(fa)
    with tracing.recording() as rec:
        losses = [step(params, momentum, tokens)[2].item()
                  for _ in range(HYBRID_STEPS)]
    launches = {"hybrid_train": dict(short_conv.launches)}
    line = dict(check="LFM2 hybrid block through sgd_step, counted",
                steps=HYBRID_STEPS, losses=losses,
                conv=dict(short_conv.launches), flash=dict(fa.launches),
                head=dict(xent.launches),
                conv_fused_rows=rec.counts.get("conv.fused_rows"))
    print(json.dumps(line), flush=True)
    n = HYBRID_STEPS
    if (short_conv.launches != dict.fromkeys(short_conv.launches, conv * n)
            or fa.launches != dict.fromkeys(fa.launches, attn * n)
            or xent.launches != dict.fromkeys(xent.launches, n)
            or line["conv_fused_rows"] != conv * n * cfg.batch * cfg.seq_len
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"the hybrid block's steps went another way: "
                             f"{line}")

    _reset(fa)
    with torch.no_grad():
        logits = workload.forward(params, tokens, cfg, "flash")
        finite = bool(torch.isfinite(logits).all())
    del logits
    launches["hybrid_infer"] = dict(short_conv.launches)
    if (not finite or short_conv.launches != {"conv_fwd": conv,
                                              "conv_bwd": 0}
            or fa.launches != {"flash_fwd": attn, "flash_bwd_dkv": 0,
                               "flash_bwd_dq": 0}):
        raise AssertionError(f"the hybrid forward launched "
                             f"{short_conv.launches} and {fa.launches}; "
                             f"finite {finite}")
    torch.cuda.empty_cache()

    _reset(fa)
    loss, grads = workload.value_and_grad(params, tokens, cfg, "flash")
    again_loss, again = workload.value_and_grad(params, tokens, cfg, "flash")
    expected = {"conv_fwd": 2 * conv, "conv_bwd": 2 * conv}
    if short_conv.launches != expected:
        raise AssertionError(f"kernel steps launched {short_conv.launches}, "
                             f"expected {expected}")
    with mock.patch.object(short_conv, "gated_conv",
                           short_conv.gated_conv_plain):
        ref_loss, ref = workload.value_and_grad(params, tokens, cfg, "flash")
    if short_conv.launches != expected:
        raise AssertionError(f"plain step launched a conv kernel: "
                             f"{short_conv.launches}")
    named = workload._named_leaves(grads)
    repeat_equal = bool(torch.equal(loss, again_loss)) and all(
        torch.equal(g, a) for (_, g), a in zip(named, workload._leaves(again)))
    rel, unequal = {}, []
    for (key, g), r in zip(named, workload._leaves(ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient for {key}")
        # moe_bias gets no gradient: 0 on both sides
        rel[key] = ((g - r).abs().max()
                    / r.abs().max().clamp(min=1e-30)).item()
        if not torch.equal(g, r):
            unequal.append(key)
    del grads, again, ref, params, momentum
    torch.cuda.empty_cache()
    line = dict(check="LFM2 hybrid training step: conv kernels vs plain "
                "convolution", loss=loss.item(), plain_loss=ref_loss.item(),
                loss_equal=bool(torch.equal(loss, ref_loss)),
                loss_diff=abs(loss.item() - ref_loss.item()),
                kernel_repeat_equal=repeat_equal, unequal_leaves=unequal,
                max_grad_rel=max(rel.values()), grad_rel=rel,
                grad_rel_tol=STEP_GRAD_REL_TOL, loss_tol=STEP_LOSS_TOL)
    print(json.dumps(line), flush=True)
    taps_only = all(key.endswith("conv_w") for key in unequal)
    if (line["max_grad_rel"] > STEP_GRAD_REL_TOL
            or line["loss_diff"] > STEP_LOSS_TOL
            or (repeat_equal and not (line["loss_equal"] and taps_only))):
        raise AssertionError("the hybrid step through the conv kernels "
                             "disagrees with the plain convolution")
    return launches


class _TopkRouter:
    """Stands in for `workload._route_topk`: records the experts each MoE
    layer chooses in the forward, by its router leaf (so that the layer's
    recomputation inside the backward finds them too); with `pinned`,
    another router's record, routes to those experts, weighted from its
    own scores as `_route_topk` weights its choice, and counts the rows
    whose own choice is the pinned one."""

    def __init__(self, torch, workload, pinned=None):
        self.torch, self.workload, self.pinned = torch, workload, pinned
        self.original = workload._route_topk
        self.chosen, self.rows, self.agreeing = {}, 0, 0

    def __call__(self, xt, wr, bias, cfg):
        weights, chosen = self.original(xt, wr, bias, cfg)
        if self.pinned is None:
            self.chosen.setdefault(wr.data_ptr(), chosen)
            return weights, chosen
        given = self.pinned[wr.data_ptr()]
        if self.torch._C._current_graph_task_id() == -1:   # the forward
            same = (chosen.sort(-1).values == given.sort(-1).values).all(-1)
            self.rows += same.numel()
            self.agreeing += int(same.sum())
        scores = self.torch.sigmoid(xt.float()
                                    @ self.workload._bf16(wr).float())
        weights = scores.gather(1, given)
        weights = weights / (weights.sum(-1, keepdim=True) + cfg.router_eps)
        if cfg.routed_scale != 1:
            weights = weights * cfg.routed_scale
        return weights, given


def _by_heads(torch, fn, n: int):
    """`fn`, a plain version over (heads_batch, seq, ...) tensors, run `n`
    heads at a time and its outputs joined: each head's are its own."""
    def run(*args, **kwargs):
        hb = args[0].shape[0]
        parts = [fn(*(a[i:i + n] if isinstance(a, torch.Tensor) else a
                      for a in args), **kwargs) for i in range(0, hb, n)]
        if isinstance(parts[0], torch.Tensor):
            return torch.cat(parts)
        return tuple(torch.cat(out) for out in zip(*parts))
    return run


def check_latent_block(torch, fa, dev) -> dict:
    """Phase 7 for DeepSeek-V3's block (LATENT_BLOCK) through
    `workload.sgd_step` and `workload.forward`, each with the launch counts
    set to 0 just before it: under remat a step launches K1 twice an MLA
    layer (its forward and the recomputation in the backward), K2 and K3
    once and the head's pair once, and counts b s heads `mla.flash_rows`
    an MLA layer (not in the recomputation); a forward launches K1 once a
    layer alone, with the same rows. Then one step's loss and gradients
    against the same step with the plain versions of K1-K3 in their place,
    on the kernel step's routes (`_TopkRouter`). Returns {path: K1-K3
    launches}."""
    from tpu_device_plugin_torch.validator import tracing, workload, xent
    cfg = workload.ModelConfig(**LATENT_BLOCK)
    n, layers = LATENT_BLOCK_STEPS, cfg.n_layers
    rows = cfg.batch * cfg.seq_len * cfg.n_heads
    step, params, momentum, tokens = workload.build_workload(
        cfg, seed=0, attention="flash", device=dev)
    _reset(fa)
    with tracing.recording() as rec:
        losses = [step(params, momentum, tokens)[2].item() for _ in range(n)]
    launches = {"latent_train": dict(fa.launches)}
    line = dict(check="DeepSeek-V3 latent block through sgd_step, counted",
                steps=n, losses=losses, flash=dict(fa.launches),
                head=dict(xent.launches),
                mla_flash_rows=rec.counts.get("mla.flash_rows"),
                held_share=rec.counts.get("moe.held", 0)
                / max(rec.counts.get("moe.routed", 0), 1),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps(line), flush=True)
    if (fa.launches != {"flash_fwd": 2 * layers * n,
                        "flash_bwd_dkv": layers * n,
                        "flash_bwd_dq": layers * n}
            or xent.launches != dict.fromkeys(xent.launches, n)
            or line["mla_flash_rows"] != layers * n * rows
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"the latent block's steps went another way: "
                             f"{line}")

    _reset(fa)
    with torch.no_grad(), tracing.recording() as rec:
        logits = workload.forward(params, tokens, cfg, "flash")
        finite = bool(torch.isfinite(logits).all())
    del logits
    launches["latent_infer"] = dict(fa.launches)
    if (not finite or fa.launches != {"flash_fwd": layers, "flash_bwd_dkv": 0,
                                      "flash_bwd_dq": 0}
            or rec.counts.get("mla.flash_rows") != layers * rows):
        raise AssertionError(f"the latent forward launched {fa.launches} "
                             f"with {rec.counts.get('mla.flash_rows')} rows; "
                             f"finite {finite}")
    torch.cuda.empty_cache()

    _reset(fa)
    kernel_routes = _TopkRouter(torch, workload)
    with mock.patch.object(workload, "_route_topk", kernel_routes):
        loss, grads = workload.value_and_grad(params, tokens, cfg, "flash")
    expected = {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers,
                "flash_bwd_dq": layers}
    if fa.launches != expected:
        raise AssertionError(f"kernel step launched {fa.launches}, expected "
                             f"{expected}")
    plain_routes = _TopkRouter(torch, workload, kernel_routes.chosen)
    with mock.patch.object(fa, "flash_attention_fwd", _by_heads(
            torch, fa.flash_attention_plain, PLAIN_HEADS)), \
            mock.patch.object(fa, "flash_attention_bwd", _by_heads(
                torch, fa.flash_attention_bwd_plain, PLAIN_HEADS)), \
            mock.patch.object(workload, "_route_topk", plain_routes):
        ref_loss, ref = workload.value_and_grad(params, tokens, cfg, "flash")
    if fa.launches != expected:
        raise AssertionError(f"plain step launched a kernel: {fa.launches}")
    rel = {}
    for (key, g), r in zip(workload._named_leaves(grads),
                           workload._leaves(ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient for {key}")
        # moe_bias gets no gradient: 0 on both sides
        rel[key] = ((g - r).abs().max()
                    / r.abs().max().clamp(min=1e-30)).item()
    del grads, ref, params, momentum
    torch.cuda.empty_cache()
    line = dict(check="DeepSeek-V3 latent training step: K1-K3 vs plain "
                "versions, plain on the kernel step's routes",
                loss=loss.item(), plain_loss=ref_loss.item(),
                loss_diff=abs(loss.item() - ref_loss.item()),
                max_grad_rel=max(rel.values()), grad_rel=rel,
                route_agreement=plain_routes.agreeing / plain_routes.rows,
                grad_rel_tol=STEP_GRAD_REL_TOL, loss_tol=STEP_LOSS_TOL)
    print(json.dumps(line), flush=True)
    if (line["max_grad_rel"] > STEP_GRAD_REL_TOL
            or line["loss_diff"] > STEP_LOSS_TOL):
        raise AssertionError("the latent step through K1-K3 disagrees with "
                             "their plain versions")
    return launches


def compare_steps(torch, fa, cfg, dev) -> dict:
    """One training step's loss and gradients through the kernels and
    through their plain versions, on the same weights and tokens."""
    from tpu_device_plugin_torch.validator import workload, xent
    _, params, _, tokens = workload.build_workload(cfg, seed=0,
                                                   attention="flash",
                                                   device=dev)
    _reset(fa)
    loss, grads = workload.value_and_grad(params, tokens, cfg, "flash")
    expected = dict.fromkeys(fa.launches, cfg.n_layers)
    head = dict.fromkeys(xent.launches, 1)
    if fa.launches != expected or xent.launches != head:
        raise AssertionError(f"kernel step launched {fa.launches} and "
                             f"{xent.launches}, expected {expected}, {head}")
    # the flash Function and the head, routed through the plain versions
    with mock.patch.object(fa, "flash_attention_fwd", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_attention_bwd",
                              fa.flash_attention_bwd_plain), \
            mock.patch.object(xent, "nll_sum", xent.nll_sum_plain):
        ref_loss, ref = workload.value_and_grad(params, tokens, cfg, "flash")
    if fa.launches != expected or xent.launches != head:
        raise AssertionError(f"plain step launched a kernel: {fa.launches}, "
                             f"{xent.launches}")
    rel = {}
    for (key, g), r in zip(workload._named_leaves(grads),
                           workload._leaves(ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite gradient for {key}")
        rel[key] = ((g - r).abs().max() / r.abs().max()).item()
    del grads, ref, params
    torch.cuda.empty_cache()
    return dict(loss=loss.item(), plain_loss=ref_loss.item(),
                loss_diff=abs(loss.item() - ref_loss.item()),
                max_grad_rel=max(rel.values()), grad_rel=rel)


def compare_forwards(torch, fa, cfg, dev) -> dict:
    """One forward through the kernel, the same forward with the kernel's
    plain version in its place, and the einsum-attention forward, on the
    same weights. Asserts finite logits of the right shape."""
    from tpu_device_plugin_torch.validator.workload import build_infer, forward
    fwd, params, tokens = build_infer(cfg, seed=0, attention="flash",
                                      device=dev)

    def plain_attention(q, k, v, sm_scale=None, causal=True):
        return fa.flash_attention_plain(q, k, v, q.shape[-1] ** -0.5, causal)

    with torch.no_grad():
        logits = fwd(params, tokens)
        with mock.patch.object(fa, "flash_attention", plain_attention):
            plain = forward(params, tokens, cfg, "flash")
        einsum = forward(params, tokens, cfg, "einsum")
    expected = (cfg.batch, cfg.seq_len, cfg.vocab)
    if tuple(logits.shape) != expected or not bool(torch.isfinite(logits).all()):
        raise AssertionError(
            f"logits {tuple(logits.shape)} not finite of shape {expected}")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def agree(a, b):
        return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

    return dict(max_abs_logit_diff_rel=rel(logits, plain),
                argmax_agreement=agree(logits, plain),
                vs_einsum_max_abs_logit_diff_rel=rel(logits, einsum),
                vs_einsum_argmax_agreement=agree(logits, einsum),
                plain_vs_einsum_argmax_agreement=agree(plain, einsum))


# Ring on one card: the allowance for the one bf16 rounding of each step's
# output before the merge. The ring merges o_b rounded to bf16 (at most
# 2^-9 of each |o_b| element, whose weights in the merge sum to 1), and K1
# in each step rounds P to bf16 against that step's running max where the
# global plain version rounds it against its own (2^-9 of each P on each
# side): at most 3 x 2^-9 x (P|V|)[r, c] = sum_i P[r, i] |V[i, c]| in all,
# held to 2^-7 x P|V|, beside the element bar and K1's term.
RING_MERGE_RTOL = 2 ** -7
RING_SHAPE = (128, 2048, 128)    # hb (batch 8 x 16 heads), global seq, d
RING_SIZES = (2, 4)


def check_ring(torch, fa, dev):
    """The ring on one card: the port's `ring_flash_forward` and
    `ring_flash_backward` at the mfu attention shape, sp threads of one
    process on their own streams (`ring_attention.run_on_threads`), against
    global attention through the plain versions. Plain functions, not
    autograd: the autograd engine runs every CUDA backward on one thread
    per device, where sp ring members would wait for each other forever.
    Returns {sp: launches} of each ring and its check lines."""
    from tpu_device_plugin_torch.validator import ring_attention as ra
    hb, seq, d = RING_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(dev).manual_seed(2)
    q, k, v, do = (torch.randn((hb, seq, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v, scale, True, True)
    # K1's term, and P|V| for the merge's allowance (f32: exp(s - lse) |V|)
    term_o = (fa.rounding_terms_fwd(q, k, v, ref_lse, scale, True)
              + RING_MERGE_RTOL / FLIP_RTOL * fa.flash_attention_plain(
                  q.float(), k.float(), v.float().abs(), scale, True))
    launches, lines = {}, []
    for sp in RING_SIZES:
        shards = [t.chunk(sp, 1) for t in (q, k, v, do)]

        def member(ring):
            qi, ki, vi, doi = (s[ring.index].contiguous() for s in shards)
            o, lse = ra.ring_flash_forward(qi, ki, vi, scale, ring)
            return (o, lse, *ra.ring_flash_backward(qi, ki, vi, o, lse, doi,
                                                    scale, ring))

        _reset(fa)
        outs = ra.run_on_threads(sp, member, device=dev)
        torch.cuda.synchronize()
        launches[sp] = dict(fa.launches)
        # rank r runs r + 1 steps: sp (sp + 1) / 2 of each kernel in all
        expected = dict.fromkeys(fa.launches, sp * (sp + 1) // 2)
        o, lse, dq, dk, dv = (torch.cat([x[j] for x in outs], 1)
                              for j in range(5))
        torch.cuda.synchronize()   # before the members' tensors are freed
        del outs
        err = {"o": _elem_err(o, ref_o, "bfloat16", term_o)}
        err_lse = (lse - ref_lse).abs().max().item()
        refs = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale, True,
                                            out_dtype=torch.float32)
        di = (do.float() * o.float()).sum(-1)
        terms = (fa.rounding_terms_dq(q, k, v, do, lse, di, scale, True),
                 *fa.rounding_terms_dkv(q, k, v, do, lse, di, scale, True))
        for name, g, ref, term in zip(("dq", "dk", "dv"), (dq, dk, dv), refs,
                                      terms):
            err[name] = _elem_err(g, ref, "bfloat16", term)
        del refs, terms, di
        torch.cuda.empty_cache()
        finite = all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv))
        ok = (finite and err_lse <= LSE_TOL and launches[sp] == expected
              and all(e["tol_ratio"] <= 1.0 for e in err.values()))
        line = dict(check="ring on one card: ring_flash_forward/backward vs "
                    "global plain attention", sp=sp, hb=hb, seq=seq,
                    s_local=seq // sp, d=d, dtype="bfloat16",
                    tol_ratio={n: e["tol_ratio"] for n, e in err.items()},
                    max_abs_err={n: e["max_abs_err"] for n, e in err.items()},
                    lse_max_abs_err=err_lse, launches=launches[sp],
                    expected_launches=expected, merge_rtol=RING_MERGE_RTOL,
                    ok=ok)
        print(json.dumps(line), flush=True)
        lines.append(line)
        if not ok:
            raise AssertionError(f"ring on one card (sp {sp}) failed: {line}")
    return launches, lines


def time_ring_modes(torch, fa, dev):
    """Each kernel in its ring-step modes at s_local 512 and 1024 (the mfu
    shape over sp 4 and 2): K1 full with lse, K2 and K3 full with f32
    outputs, and the causal diagonal step beside them; each with its bound
    and SDPA's time at the same shape and mask (`library_ms`)."""
    import torch.nn.functional as F
    hb, _, d = RING_SHAPE
    scale = d ** -0.5
    gen = torch.Generator(dev).manual_seed(3)
    modes = {name: [] for name in fa.launches}
    for s_local in (512, 1024):
        q, k, v, do = (torch.randn((hb, s_local, d), generator=gen,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        b = 8
        q4, k4, v4 = (t.view(b, hb // b, s_local, d).detach().requires_grad_()
                      for t in (q, k, v))
        do4 = do.view(b, hb // b, s_local, d)
        for causal in (False, True):
            o, lse = fa.flash_attention_fwd(q, k, v, scale, causal, True)
            di = (do.float() * o.float()).sum(-1)
            dq, dk, dv = (torch.empty(q.shape, dtype=torch.float32,
                                      device=dev) for _ in range(3))
            ms = {
                "flash_fwd": _cuda_ms(torch, lambda: fa.flash_attention_fwd(
                    q, k, v, scale, causal, True), 20),
                "flash_bwd_dkv": _cuda_ms(torch, lambda: fa.launch_bwd(
                    q, k, v, do, lse, di, None, dk, dv, scale, causal), 20),
                "flash_bwd_dq": _cuda_ms(torch, lambda: fa.launch_bwd(
                    q, k, v, do, lse, di, dq, None, None, scale, causal), 20)}
            lib_fwd = _cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), 20)
            out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
            lib_bwd = _cuda_ms(torch, lambda: torch.autograd.grad(
                out4, (q4, k4, v4), do4, retain_graph=True), 20)
            del out4
            bounds = bwd_bounds(hb, s_local, d, "bfloat16", causal, "float32")
            bounds["flash_fwd"] = attention_bound(hb, s_local, d, "bfloat16",
                                                  causal)
            for name, t in ms.items():
                bound_ms, bound_by, flops = bounds[name]
                row = dict(s_local=s_local, causal=causal,
                           out_dtype=("bfloat16" if name == "flash_fwd"
                                      else "float32"),
                           ms=t, bound_ms=bound_ms, bound_by=bound_by,
                           **_speed(t, bound_ms, flops),
                           library_ms=lib_fwd if name == "flash_fwd"
                           else lib_bwd)
                modes[name].append(row)
                print(json.dumps(dict(kernel=name, ring_mode=True, **row)),
                      flush=True)
        del q, k, v, do, q4, k4, v4, do4
        torch.cuda.empty_cache()
    return modes


def check_mesh_nccl(torch, fa, cfg, dev):
    """The mesh path over NCCL at world size 1: one training step through
    `build_workload(cfg, mesh)` on `slice_mesh(1)` (dp = sp = tp = 1, every
    collective the identity) against one through the no-mesh build, same
    seed. The losses and every updated leaf and momentum must be bit for
    bit equal. Returns the check line and the mesh step's launches."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    from tpu_device_plugin_torch.validator import workload
    from tpu_device_plugin_torch.validator.mesh import mesh_shape, slice_mesh

    step, params, momentum, tokens = workload.build_workload(
        cfg, seed=0, device=dev)
    _, _, ref_loss = step(params, momentum, tokens)
    ref = [t.clone() for t in workload._leaves(params)
           + workload._leaves(momentum)]
    del step, params, momentum, tokens
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-nccl-")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = slice_mesh(1, device_type="cuda")
        step, params, momentum, tokens = workload.build_workload(
            cfg, mesh, seed=0, device=dev)
        _reset(fa)
        _, _, loss = step(params, momentum, tokens)
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        got = workload._leaves(params) + workload._leaves(momentum)
        names = [f"params.{n}" for n, _ in workload._named_leaves(params)]
        names += [f"momentum.{n}" for n, _ in workload._named_leaves(momentum)]
        unequal = [n for n, a, b in zip(names, got, ref) if not torch.equal(a, b)]
        shape = mesh_shape(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    expected = dict.fromkeys(fa.launches, cfg.n_layers)
    ok = (bool(torch.equal(loss, ref_loss)) and not unequal
          and launches == expected)
    line = dict(check="mesh path over NCCL, world size 1, vs the no-mesh "
                "step: bit for bit", mesh=shape, backend="nccl",
                loss=loss.item(), no_mesh_loss=ref_loss.item(),
                leaves_compared=len(names), unequal_leaves=unequal,
                launches=launches, ok=ok)
    del params, momentum, got, ref
    torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    if not ok:
        raise AssertionError(f"the NCCL mesh step differs from the no-mesh "
                             f"step: {line}")
    return line, launches


def check_gpipe(torch, fa, cfg, dev) -> dict:
    """Phase 8: one GPipe step's loss and gradients on two stage threads
    against the non-pipelined step (einsum attention, same seed), then
    1 + N + 2N steps timed as `probe._train` times them. The reference
    step recomputes each layer in its backward (remat, the same loss and
    gradients to the bit in tests/test_torch_pipeline.py): without it the
    whole batch's einsum scores, 3.2 GB per layer kept for the backward,
    would take as much of the card as the two stages together."""
    from dataclasses import replace

    from tpu_device_plugin_torch.validator import pipeline, workload
    from tpu_device_plugin_torch.validator.ring_attention import run_on_threads
    params, tokens = workload._place(cfg, dev, 0)
    ref_loss, ref = workload.value_and_grad(params, tokens,
                                            replace(cfg, remat=True), "einsum")
    ref = dict(workload._named_leaves(ref))
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    per_stage = cfg.n_layers // GPIPE_STAGES
    steps = 2

    def stage(link):
        step, p, m, t = pipeline.build_gpipe(cfg, None, GPIPE_MICRO,
                                             device=dev, link=link)
        loss, grads = pipeline.gpipe_value_and_grad(p, t, cfg, None,
                                                    GPIPE_MICRO, link)
        rel = {}
        for key, g in workload._named_leaves(grads):
            r = ref[key]
            if key.startswith("layers."):
                r = r[link.index * per_stage:(link.index + 1) * per_stage]
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"stage {link.index}: non-finite {key}")
            rel[key] = ((g - r).abs().max() / r.abs().max()).item()
        del grads
        loss_start = step(p, m, t)[2].item()

        def run_block(k):
            t0 = time.monotonic()
            for _ in range(k):
                loss_k = step(p, m, t)[2]
            val = loss_k.item()
            return time.monotonic() - t0, val

        t_n, _ = run_block(steps)
        t_2n, loss_end = run_block(2 * steps)
        diff = t_2n - t_n
        return dict(loss=loss.item(), grad_rel=rel, loss_start=loss_start,
                    loss_end=loss_end,
                    step_time_s=diff / steps if diff > 0
                    else t_2n / (2 * steps))

    _reset(fa)
    outs = run_on_threads(GPIPE_STAGES, stage, device=dev,
                          group=pipeline.ThreadLink(GPIPE_STAGES))
    launches = dict(fa.launches)
    rel = {f"stage{i}.{key}": v for i, out in enumerate(outs)
           for key, v in out["grad_rel"].items()}
    line = dict(check="GPipe at mfu, pp 2 as threads on one card, vs the "
                "non-pipelined step (einsum)", stages=GPIPE_STAGES,
                n_micro=GPIPE_MICRO, loss=outs[0]["loss"],
                plain_loss=ref_loss.item(),
                loss_diff=abs(outs[0]["loss"] - ref_loss.item()),
                stage_losses_equal=len({o["loss"] for o in outs}) == 1,
                max_grad_rel=max(rel.values()), grad_rel=rel,
                loss_start=outs[0]["loss_start"], loss_end=outs[0]["loss_end"],
                steps=1 + 3 * steps, step_time_s=outs[0]["step_time_s"],
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                launches=launches, grad_rel_tol=STEP_GRAD_REL_TOL,
                loss_tol=STEP_LOSS_TOL)
    line["ok"] = (line["loss_diff"] <= STEP_LOSS_TOL
                  and line["max_grad_rel"] <= STEP_GRAD_REL_TOL
                  and line["stage_losses_equal"]
                  and line["loss_end"] < line["loss_start"]
                  and not any(launches.values()))
    del ref, outs
    torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    if not line["ok"]:
        raise AssertionError(f"GPipe at mfu failed: {line}")
    return line


def check_benches(torch, fa, dev) -> dict:
    """Phase 9: each bench counted from 0; the flash side ok in every cell,
    every train chain through K1, K2 and K3, every forward chain through K1
    alone. Returns {path: launches}."""
    from tpu_device_plugin_torch.validator import attn_bench, ring_bench
    runs = (
        ("attn_bench", "flash", attn_bench.bench_attention,
         [dict(seq_lens=(1024, 2048, 4096), hb=8), dict(seq_lens=(2048,),
                                                       hb=128)]),
        ("ring_bench", "ring_flash", ring_bench.bench_ring,
         [dict(seq_lens=(4096,), sp=1), dict(seq_lens=(4096,), sp=2)]),
    )
    launches = {}
    for path, side, bench, calls in runs:
        _reset(fa)
        total = dict.fromkeys(fa.launches, 0)
        for kw in calls:
            result = bench(iters=3, device=dev, **kw)
            print(json.dumps(dict(bench=path, **result)), flush=True)
            if not result[f"{side}_ok"]:
                raise AssertionError(f"{path} {kw}: the flash side failed")
            for cell in result["cells"]:
                fwd = cell[f"{side}_fwd_launches"]
                train = cell[f"{side}_train_launches"]
                if not (fwd["flash_fwd"] > 0 and fwd["flash_bwd_dkv"] == 0
                        and fwd["flash_bwd_dq"] == 0
                        and all(n > 0 for n in train.values())):
                    raise AssertionError(
                        f"{path} {kw} seq {cell['seq']}: launches forward "
                        f"{fwd}, train {train}")
                for name in total:
                    total[name] += fwd[name] + train[name]
        launches[path] = dict(fa.launches)
        if launches[path] != total:
            raise AssertionError(f"{path}: {launches[path]} launched, the "
                                 f"chains count {total}")
        torch.cuda.empty_cache()
    print(json.dumps({"launches": launches}), flush=True)
    return launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(argv, timeout_s: float):
    """The port's CLI in a subprocess from the repository root: (exit
    code, its last stdout line as JSON or None, seconds, stderr's end)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_device_plugin_torch.validator", *argv],
        cwd=root, capture_output=True, text=True, timeout=timeout_s)
    took = time.monotonic() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError):
        last = None
    return proc.returncode, last, took, proc.stderr[-3000:]


def check_multiprocess(torch, fa, cfg, train_report) -> dict:
    """Phase 10: the CLI at mfu joined as a world of one (training, then
    serving), and a coordinator nobody serves. `train_report` is phase 4's
    training report. Returns {path: launches}, the counts each run's rank
    reported."""
    launches, runs = {}, {}
    for label, mode in (("multiprocess_train", "train"),
                        ("multiprocess_infer", "infer")):
        gc.collect()
        torch.cuda.empty_cache()
        argv = ["--preset", "mfu", "--mode", mode,
                "--steps", str(MP_STEPS[mode]),
                "--coordinator", f"127.0.0.1:{_free_port()}",
                "--num-processes", "1", "--process-id", "0"]
        # the counts come from the process that ran the steps (a fresh
        # one: they start at 0), over the steps or forwards alone
        rc, report, took, err = _cli(argv, 600)
        if rc != 0 or report is None or not report["ok"]:
            raise AssertionError(f"{label}: exit {rc}, report {report}, "
                                 f"stderr {err}")
        if mode == "train":
            expected = dict.fromkeys(fa.launches,
                                     cfg.n_layers * report["steps"])
            if not report["loss_end"] < report["loss_start"]:
                raise AssertionError(f"{label}: the loss did not fall")
            if report["loss_start"] != train_report.loss_start:
                raise AssertionError(
                    f"{label}: loss_start {report['loss_start']!r}, phase 4 "
                    f"{train_report.loss_start!r}")
        else:
            expected = {"flash_fwd": cfg.n_layers * report["forwards"],
                        "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
        work = report["steps"] + report["forwards"]
        if work <= 0 or report["launches"] != expected:
            raise AssertionError(f"{label}: launches {report['launches']}, "
                                 f"expected {expected}")
        if (report["n_devices"] != 1
                or report["mesh_shape"] != {"dp": 1, "sp": 1, "tp": 1}):
            raise AssertionError(f"{label}: n_devices {report['n_devices']}"
                                 f", mesh {report['mesh_shape']}")
        launches[label] = report["launches"]
        runs[label] = report
        print(json.dumps(dict(
            check=f"{label}: the CLI at mfu, joined as a world of one",
            wall_s=took, **{k: report[k] for k in (
                "ok", "n_devices", "mesh_shape", "rendezvous_s",
                "devices_visible_s", "first_step_s", "step_time_s",
                "loss_start", "loss_end", "infer_p50_ms", "steps",
                "forwards", "launches")})), flush=True)

    rc, report, took, err = _cli(
        ["--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes",
         "2", "--process-id", "1", "--init-timeout", str(INIT_TIMEOUT_S)],
        INIT_TIMEOUT_S + INIT_SLACK_S + 30)
    line = dict(check="unreachable coordinator: a JSON report, exit 1",
                rc=rc, wall_s=took, limit_s=INIT_TIMEOUT_S + INIT_SLACK_S,
                report=report)
    line["ok"] = (rc == 1 and took <= INIT_TIMEOUT_S + INIT_SLACK_S
                  and report is not None and report["ok"] is False
                  and report["error"].startswith("distributed init:"))
    print(json.dumps(line), flush=True)
    if not line["ok"]:
        raise AssertionError(f"unreachable coordinator: {line}, stderr {err}")

    train = runs["multiprocess_train"]
    print(json.dumps(dict(
        check="the rendezvous's cost at mfu (train)",
        **{k: [train[k], getattr(train_report, k)] for k in (
            "rendezvous_s", "devices_visible_s", "first_step_s",
            "step_time_s")},
        order="[the CLI joined as a world of one, phase 4 in this "
              "process]")), flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    from tpu_device_plugin_torch.validator import _kernels
    from tpu_device_plugin_torch.validator import flash_attention as fa
    from tpu_device_plugin_torch.validator import short_conv, xent
    from tpu_device_plugin_torch.validator.probe import PRESETS, validate_slice
    from tpu_device_plugin_torch.validator.workload import ModelConfig

    # 1. the card
    print(_nvidia_smi(), flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}",
          flush=True)
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.monotonic()
    _kernels.build_all()
    print(f"kernels built in {time.monotonic() - t0:.1f} s", flush=True)
    for kernel, log in _kernels.build_log.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {kernel}: {ln.strip()}")

    # 3. kernels against their plain versions
    entries = [check_flash_fwd(torch, fa, dev), *check_flash_bwd(torch, fa, dev)]
    torch.cuda.empty_cache()
    for entry, line in zip(entries, check_flash_latent(torch, fa, dev)):
        entry["at_latent"] = line
    xent_entry = check_xent(torch, dev)
    torch.cuda.empty_cache()
    conv_entry = check_conv(torch, dev)
    torch.cuda.empty_cache()
    ssd_entry = check_ssd(torch, fa, dev)
    torch.cuda.empty_cache()
    conv_silu_entry = check_conv_silu(torch, dev)
    torch.cuda.empty_cache()

    # 4. the serving and the training path at the mfu preset, counted
    _memory(torch, "4")
    cfg = ModelConfig(**PRESETS["mfu"])
    _reset(fa)
    report = validate_slice(cfg=cfg, steps=5, attention="flash", mode="infer",
                            device="cuda")
    infer_launches = dict(fa.launches)
    infer_xent = dict(xent.launches)
    infer_conv = dict(short_conv.launches)
    print(report.to_json(), flush=True)
    if not report.ok:
        raise AssertionError(f"validate_slice(mfu, infer) not ok: {report.error}")
    expected = {"flash_fwd": cfg.n_layers * report.forwards,
                "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    if infer_xent != dict.fromkeys(xent.launches, 0):
        raise AssertionError(f"serving launched the head's kernels: "
                             f"{infer_xent}")
    if report.forwards <= 0 or infer_launches != expected:
        raise AssertionError(
            f"serving launches {infer_launches} in {report.forwards} "
            f"forwards; expected {expected}")
    torch.cuda.empty_cache()

    _reset(fa)
    train_report = validate_slice(cfg=cfg, steps=3, attention="flash",
                                  mode="train", device="cuda")
    train_launches = dict(fa.launches)
    train_xent = dict(xent.launches)
    train_conv = dict(short_conv.launches)
    print(train_report.to_json(), flush=True)
    if not train_report.ok or not train_report.loss_end < train_report.loss_start:
        raise AssertionError(f"validate_slice(mfu, train) not ok: "
                             f"{train_report.error}")
    expected = dict.fromkeys(fa.launches, cfg.n_layers * train_report.steps)
    if train_report.steps <= 0 or train_launches != expected:
        raise AssertionError(
            f"training launches {train_launches} in {train_report.steps} "
            f"steps; expected {cfg.n_layers} of each kernel per step")
    if train_xent != dict.fromkeys(xent.launches, train_report.steps):
        raise AssertionError(
            f"the head's kernels launched {train_xent} in "
            f"{train_report.steps} steps; expected one of each per step")
    if infer_conv != train_conv or train_conv != dict.fromkeys(
            short_conv.launches, 0):
        raise AssertionError(f"a block without conv layers launched the "
                             f"conv kernels: {infer_conv}, {train_conv}")
    print(json.dumps({"launches": {"infer": infer_launches,
                                   "train": train_launches,
                                   "head_infer": infer_xent,
                                   "head_train": train_xent}}), flush=True)
    xent_entry["launches"] = sum(train_xent.values())
    xent_entry["launches_by_path"] = {"infer": infer_xent, "train": train_xent}
    for entry in entries:
        entry["launches"] = (infer_launches[entry["name"]]
                             + train_launches[entry["name"]])
        entry["launches_by_path"] = {"infer": infer_launches[entry["name"]],
                                     "train": train_launches[entry["name"]]}
    torch.cuda.empty_cache()

    # the logits, against the same forward through the kernel's plain version
    for label, forward_cfg, argmax_min in (
            ("small", ModelConfig(**SMALL), ARGMAX_AGREE_MIN),
            ("mfu", cfg, ARGMAX_AGREE_MIN_MFU)):
        line = compare_forwards(torch, fa, forward_cfg, dev)
        line.update(check=f"{label} forward: kernel vs plain attention",
                    rel_tol=LOGIT_REL_TOL, argmax_min=argmax_min)
        print(json.dumps(line), flush=True)
        if (line["max_abs_logit_diff_rel"] > LOGIT_REL_TOL
                or line["argmax_agreement"] < argmax_min):
            raise AssertionError(f"{label}: kernel forward disagrees with "
                                 "the plain-attention forward")

    # one training step's loss and gradients, against the plain versions
    for label, step_cfg in (("small", ModelConfig(**SMALL)), ("mfu", cfg)):
        line = compare_steps(torch, fa, step_cfg, dev)
        line.update(check=f"{label} training step: kernels vs plain versions",
                    grad_rel_tol=STEP_GRAD_REL_TOL, loss_tol=STEP_LOSS_TOL)
        print(json.dumps(line), flush=True)
        if (line["max_grad_rel"] > STEP_GRAD_REL_TOL
                or line["loss_diff"] > STEP_LOSS_TOL):
            raise AssertionError(f"{label}: the training step through the "
                                 "kernels disagrees with the plain versions")

    # 5. the ring on one card (sp threads, each rank's launches counted
    # from 0), the kernels in its step modes, and the mesh path over NCCL
    _memory(torch, "5")
    ring_launches, _ = check_ring(torch, fa, dev)
    torch.cuda.empty_cache()
    modes = time_ring_modes(torch, fa, dev)
    _, mesh_launches = check_mesh_nccl(torch, fa, cfg, dev)
    torch.cuda.empty_cache()

    # 6. the MoE at the mfu width
    _memory(torch, "6")
    moe_launches = check_moe(torch, fa, ModelConfig(**PRESETS["mfu"],
                                                    n_experts=MOE_EXPERTS),
                             dev)
    for entry in entries:
        kernel = entry["name"]
        for sp, counts in ring_launches.items():
            entry["launches_by_path"][f"ring_sp{sp}"] = counts[kernel]
        entry["launches_by_path"]["mesh_nccl_train"] = mesh_launches[kernel]
        for path, counts in moe_launches.items():
            entry["launches_by_path"][path] = counts[kernel]
        entry["ring_modes"] = modes[kernel]

    # 7. LFM2's hybrid block, through the conv kernels; DeepSeek-V3's
    # block, through K1-K3 at latent attention's head dims
    _memory(torch, "7")
    conv_entry["launches_by_path"] = check_hybrid(torch, fa, dev)
    conv_entry["launches"] = sum(sum(counts.values()) for counts in
                                 conv_entry["launches_by_path"].values())
    torch.cuda.empty_cache()
    for path, counts in check_latent_block(torch, fa, dev).items():
        for entry in entries:
            entry["launches_by_path"][path] = counts[entry["name"]]
    torch.cuda.empty_cache()
    for path, counts in check_granite_block(torch, fa, dev).items():
        for entry in entries:
            entry["launches_by_path"][path] = counts[entry["name"]]
        ssd_entry.setdefault("launches_by_path", {})[path] = {
            k: counts[k] for k in ("ssd_fwd", "ssd_bwd")}
        conv_silu_entry.setdefault("launches_by_path", {})[path] = {
            k: counts[k] for k in ("conv_silu_fwd", "conv_silu_bwd")}
    torch.cuda.empty_cache()

    # 8. GPipe at the mfu width, two stage threads on the card
    _memory(torch, "8")
    check_gpipe(torch, fa, cfg, dev)

    # 9. the benches, each counted from 0
    _memory(torch, "9")
    bench_launches = check_benches(torch, fa, dev)
    for entry in entries:
        for path, counts in bench_launches.items():
            entry["launches_by_path"][path] = counts[entry["name"]]
        entry["launches"] = sum(entry["launches_by_path"].values())

    # 10. the multi-process slice: the CLI joined as a world of one
    _memory(torch, "10")
    mp_launches = check_multiprocess(torch, fa, cfg, train_report)
    for entry in entries:
        for path, counts in mp_launches.items():
            entry["launches_by_path"][path] = counts[entry["name"]]
        entry["launches"] = sum(entry["launches_by_path"].values())

    # 11. results
    print(json.dumps({"kernels": entries + [xent_entry, conv_entry,
                                            ssd_entry, conv_silu_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
