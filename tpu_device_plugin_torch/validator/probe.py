"""Slice validation probe on an NVIDIA card: training and serving.

Port of `tpu_device_plugin/validator/probe.py`: process start → CUDA
device enumerated → first step done, then either training (`--mode train`,
the default: SGD steps, differenced step time, model TFLOP/s and MFU, loss
must fall) or serving (`--mode infer`: latency percentiles, tokens/s), and
a matmul/memory microbench checked against the card's datasheet peak. The
model is dense or a top-1 switch MoE (`--experts`). With more than one
device (every visible card by default) the step runs on a
(pp, dp, sp, ep, tp) mesh, one process per card (`--pp`, `--tp`, `--sp`,
`--ep`), or with the GPipe schedule over pp x dp
(`--gpipe-microbatches`, pipeline.py). `--mode attn-bench` and
`--mode ring-bench` time the flash kernels against einsum attention
(attn_bench.py, ring_bench.py) and print one JSON line. Several guests
(VMIs), each holding some of a slice's cards, compose one slice with
`--coordinator host:port --num-processes N --process-id i`: the mesh then
spans every guest's cards, and each guest prints its own report. Exit code
is non-zero when the slice is unusable, so a VMI startup probe can gate
workload admission on it; 2 marks the caller's configuration.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

_PROCESS_START = time.monotonic()


@dataclass
class SliceReport:
    ok: bool
    platform: str = ""               # "gpu" or "cpu"
    n_devices: int = 0
    device_kinds: List[str] = field(default_factory=list)
    mesh_shape: Dict[str, int] = field(default_factory=dict)
    devices_visible_s: float = 0.0   # process start -> device enumerated
    rendezvous_s: float = 0.0        # the multi-VMI join, or the seconds
                                     # until it failed (0 without one)
    first_step_s: float = 0.0        # process start -> first step done
    step_time_s: float = 0.0         # steady-state train step / forward time
    tflops_per_chip: float = 0.0     # burn-in matmul throughput (train mode)
    matmul_tflops: float = 0.0       # single-card bf16 matmul microbench
    hbm_gbps: float = 0.0            # single-card memory bandwidth estimate
    loss_start: float = 0.0
    loss_end: float = 0.0
    # physics context (peaks.py): datasheet peaks for the card and every
    # throughput as a fraction of them. 0 = unknown card (the CPU, cards
    # not in the table) — fractions exist only against a datasheet fact.
    peak_tflops: float = 0.0
    peak_hbm_gbps: float = 0.0
    mfu: float = 0.0                 # tflops_per_chip / peak (train mode)
    microbench_mfu: float = 0.0      # matmul_tflops / peak
    hbm_frac: float = 0.0            # hbm_gbps / peak_hbm_gbps
    # True when a microbench reading exceeded SUSPECT_FACTOR x the datasheet
    # peak: the measurement is a timing artifact and the run is refused
    perf_suspect: bool = False
    # serving mode: forward-only latency percentiles
    infer_p50_ms: float = 0.0
    infer_p99_ms: float = 0.0
    tokens_per_s: float = 0.0
    # forward passes (infer) and training steps (train) this validation
    # ran; in flash mode each forward launches K1 once per layer, each
    # step K1, K2 and K3 once per layer (K1 twice with remat)
    forwards: int = 0
    steps: int = 0
    # the flash kernels' launches (flash_attention.launches) during those
    # steps or forwards, in the process that ran them
    launches: Dict[str, int] = field(default_factory=dict)
    # True when the failure is the CALLER's configuration, not a broken
    # card — probes gating VMI admission must not treat it as hardware
    invalid_config: bool = False
    error: str = ""

    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)


def _workload_flops(cfg) -> float:
    """Model training FLOPs per step (fwd+bwd ~= 3x fwd matmul FLOPs).

    Counts CAUSAL attention (S*d MACs per token, not the dense 2*S*d): the
    flash kernels skip future tiles outright and the einsum path's masked
    upper triangle is waste, not work. MFU derived from this is therefore
    the conservative "model FLOPs" convention (remat's extra forward also
    uncounted). A copy of the JAX package's formula, so the two report
    the same TFLOP/s for the same step time."""
    per_token = (
        4 * cfg.d_model * cfg.d_model        # qkv+o projections
        + cfg.d_model * cfg.seq_len          # causal scores + values
        + 2 * cfg.d_model * cfg.d_ff         # mlp
    ) * 2 * cfg.n_layers + 2 * cfg.d_model * cfg.vocab * 2
    return 3.0 * per_token * cfg.batch * cfg.seq_len


# Minimum differenced compute time (seconds) for a trustworthy microbench
# reading on the card: host jitter is ~ms-scale, so the signal must stand
# ~100x above it. timing.paired_time grows the chain length to reach it.
MICROBENCH_MIN_DIFF_S = 0.25
# The same floor on the CPU, where the microbench only has to give a
# positive, plausible reading: with no floor, two chained 512^3 matmuls on
# one thread differ by ~10 ms, and on a loaded host the median of three
# paired differences came out <= 0 (a reading of 0 TFLOP/s) in 12 of 40
# calls; at 20 ms, in none of 32 (8 cores, 16 busy processes).
MICROBENCH_MIN_DIFF_S_CPU = 0.02


def _microbench(device: torch.device, min_diff_s: Optional[float] = None):
    """Single-card sanity numbers: bf16 matmul TFLOP/s and memory GB/s.

    Meant to catch a card running at a fraction of expected speed (power
    or thermal clamp, degraded memory), not to be a rigorous peak
    benchmark. Chained differencing with a minimum differenced time on
    the card, so neither the fixed sync cost nor jitter can pass for (or
    hide) compute time."""
    from .timing import paired_time
    on_gpu = device.type == "cuda"
    if min_diff_s is None:
        min_diff_s = (MICROBENCH_MIN_DIFF_S if on_gpu
                      else MICROBENCH_MIN_DIFF_S_CPU)
    n = 4096 if on_gpu else 512
    # row-stochastic so the chained products stay finite in bf16
    x = torch.full((n, n), 1.0 / n, dtype=torch.bfloat16, device=device)

    def mm_chain(k):
        def run(a):
            for _ in range(k):
                a = a @ x
            return a.float().sum()
        return run

    iters = 16 if on_gpu else 2
    mm_s = paired_time(mm_chain, (x,), 3, iters, min_diff_s)
    tflops = 2.0 * n ** 3 / mm_s / 1e12 if mm_s > 0 else 0.0

    m = (256 if on_gpu else 16) * 1024 * 1024 // 4
    big = torch.ones((m,), dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)

    def add_chain(k):
        # fma, not a pure increment, in one elementwise pass per iteration:
        # z' = 1 + 1.000001 * z reads and writes m floats once
        def run(z):
            for _ in range(k):
                z = torch.add(one, z, alpha=1.000001)
            return z[0]
        return run

    add_s = paired_time(add_chain, (big,), 3, iters, min_diff_s)
    gbps = 2.0 * m * 4 / add_s / 1e9 if add_s > 0 else 0.0
    return tflops, gbps


# Seconds a validation over several devices may take, start-up included,
# before its processes are killed and the run reported as failed.
MESH_TIMEOUT_S = 900.0


def join_slice(coordinator: str, num_processes: Optional[int],
               process_id: Optional[int], init_timeout: float = 60,
               device=None, n_devices: Optional[int] = None):
    """This guest's part of a slice composed over several guest processes
    (`distributed.join`): its local devices on `device` (CUDA by default;
    `n_devices`, by default every visible card on CUDA and 1 on the CPU)
    are put in with their names. Returns the `distributed.World` that
    `validate_slice(world=)` takes; raises on a failed rendezvous."""
    from .distributed import join
    from .workload import resolve_device
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    kinds = ([torch.cuda.get_device_name(i) for i in range(n_devices)]
             if dev.type == "cuda" else [dev.type] * n_devices)
    return join(coordinator, num_processes, process_id, kinds, init_timeout)


def validate_slice(cfg=None, steps: int = 20, attention: Optional[str] = None,
                   mode: str = "train", device=None, tp: Optional[int] = None,
                   sp: Optional[int] = None, n_devices: Optional[int] = None,
                   pp: Optional[int] = None,
                   ep: Optional[int] = None,
                   gpipe_microbatches: int = 0, world=None) -> SliceReport:
    """Validation of a slice: training steps (`mode="train"`) or serving
    forwards (`mode="infer"`) on `device` (CUDA by default).

    `n_devices` (every visible card on CUDA, 1 on the CPU, by default) is
    factored into a (pp, dp, sp, ep, tp) mesh by `mesh.mesh_dims`; a shape
    that does not divide lands in `error`. With one device there is no
    mesh. With more, one process per device runs the mesh (gloo processes
    on the CPU): rank 0 fills the report, `ok` is every rank's verdict
    ANDed, and the microbench runs on rank 0's card. `mesh_shape` lists
    the mesh's axes (pp and ep where they are larger than 1).

    With `world` (`join_slice`), the slice is the world's: this guest's
    `n_devices` (by default all it joined with) run as its global ranks,
    one process each even for one device, and the mesh is factored over
    the world's size. `n_devices` and `device_kinds` are the world's; the
    report is that of this guest's first rank, whose card runs the
    microbench; `ok` is the whole world's verdict.

    With `gpipe_microbatches` > 0, training runs the GPipe schedule over
    that many microbatches (`pipeline.build_gpipe`, einsum attention) on
    a pp x dp mesh; a configuration it cannot run (a local batch that
    does not divide, no pp axis, sp, tp or ep > 1) is `invalid_config`."""
    report = SliceReport(ok=False)
    if mode not in ("train", "infer"):
        report.invalid_config = True
        report.error = (f"mode {mode!r} is not a validation: 'train' or "
                        "'infer'; the benches are attn_bench.bench_attention "
                        "and ring_bench.bench_ring (--mode attn-bench, "
                        "--mode ring-bench)")
        return report
    try:
        from .mesh import mesh_dims
        from .workload import ModelConfig, resolve_device
        dev = resolve_device(device)
        report.devices_visible_s = time.monotonic() - _PROCESS_START
        if n_devices is None:
            n_devices = (world.local if world is not None
                         else torch.cuda.device_count() if dev.type == "cuda"
                         else 1)
        report.n_devices = n_devices if world is None else world.size
        report.rendezvous_s = 0.0 if world is None else world.join_s
        report.platform = "gpu" if dev.type == "cuda" else dev.type
        if world is not None:
            report.device_kinds = world.kinds
        elif dev.type == "cuda":
            ids = [dev.index] if n_devices == 1 else range(n_devices)
            report.device_kinds = sorted({torch.cuda.get_device_name(i)
                                          for i in ids})
        else:
            report.device_kinds = [dev.type]
        dims = dict(mesh_dims(report.n_devices, tp, sp, pp, ep))
        cfg = cfg or ModelConfig()
        steps = max(steps, 1)
        gpipe = gpipe_microbatches if mode == "train" else 0
        if gpipe:
            # checks that need the mesh (hence dp, hence the local batch):
            # the caller's configuration, never a broken-slice verdict
            from .pipeline import check_gpipe
            dp = dims["dp"]
            if cfg.batch % dp or (cfg.batch // dp) % gpipe:
                report.invalid_config = True
                report.error = (
                    f"invalid configuration: batch {cfg.batch} over "
                    f"dp={dp} gives local batch {cfg.batch // dp}, not "
                    f"divisible by --gpipe-microbatches {gpipe}")
                return report
            try:
                check_gpipe(cfg, dims, gpipe, cfg.batch // dp)
            except ValueError as exc:
                report.invalid_config = True
                report.error = f"invalid configuration: {exc}"
                return report
        if n_devices > 1 or world is not None:
            from .distributed import spawn
            report.mesh_shape = dims
            first = 0 if world is None else world.offset
            ranks = spawn(_validate_rank, n_devices, dev.type, MESH_TIMEOUT_S,
                          args=(cfg, steps, attention, mode, _PROCESS_START,
                                gpipe, first),
                          mesh=dict(tp=dims["tp"], sp=dims["sp"], pp=pp,
                                    ep=ep), world=world)
            kept = ("platform", "n_devices", "device_kinds", "mesh_shape",
                    "devices_visible_s", "rendezvous_s")
            for key, value in ranks[0].items():
                if key not in kept:
                    setattr(report, key, value)
            return report
        _run(report, cfg, steps, attention, mode, dev, gpipe=gpipe)
        _check_card(report, dev)
    except Exception as exc:  # report, don't crash the probe harness
        report.error = f"{type(exc).__name__}: {exc}"
    return report


def _run(report: SliceReport, cfg, steps: int, attention, mode: str, dev,
         mesh=None, gpipe: int = 0) -> None:
    from .flash_attention import launches
    before = dict(launches)
    try:
        if mode == "infer":
            _serve(report, cfg, steps, attention, dev, mesh)
        else:
            _train(report, cfg, steps, attention, dev, mesh, gpipe)
    finally:
        report.launches = {k: launches[k] - before[k] for k in launches}


def _validate_rank(rank: int, mesh, cfg, steps: int, attention, mode: str,
                   process_start: float, gpipe: int = 0,
                   first: int = 0) -> Optional[dict]:
    """One rank of a validation over a mesh (run by `distributed.spawn`):
    its part of the steps or forwards, then the verdict ANDed over every
    rank; the guest's first rank (`first`: 0, or the world's offset) also
    runs the microbench and returns its report."""
    import torch.distributed as dist
    global _PROCESS_START
    _PROCESS_START = process_start   # the caller's process start
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    report = SliceReport(ok=False, n_devices=dist.get_world_size())
    _run(report, cfg, steps, attention, mode, dev, mesh, gpipe)
    verdict = torch.tensor([int(report.ok)], device=dev)
    dist.all_reduce(verdict, op=dist.ReduceOp.MIN)
    if report.ok and not verdict.item():
        report.ok = False
        report.error = "another rank's verdict failed"
    if rank != first:
        return None
    _check_card(report, dev)
    return dict(report.__dict__)


def _check_card(report: SliceReport, dev) -> None:
    """Microbench + physics check after the verdict. A card slower than
    peak is diagnostic-only; a card MEASURING FASTER than its datasheet
    peak is a broken estimator and vetoes the run."""
    try:
        report.matmul_tflops, report.hbm_gbps = _microbench(dev)
        from . import peaks
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type)
        peak, suspect, why = peaks.check(
            kind, report.matmul_tflops, report.hbm_gbps)
        if suspect:
            # one retry at a 4x-taller noise floor; a retry that itself
            # fails keeps the suspect verdict
            try:
                report.matmul_tflops, report.hbm_gbps = _microbench(
                    dev, MICROBENCH_MIN_DIFF_S * 4)
                peak, suspect, why = peaks.check(
                    kind, report.matmul_tflops, report.hbm_gbps)
            except Exception as exc:
                why += (f" (retry failed: {type(exc).__name__}: {exc}; "
                        "keeping suspect verdict)")
        if peak is not None:
            report.peak_tflops = peak.bf16_tflops
            report.peak_hbm_gbps = peak.hbm_gbps
            report.microbench_mfu = report.matmul_tflops / peak.bf16_tflops
            report.hbm_frac = report.hbm_gbps / peak.hbm_gbps
            if report.tflops_per_chip:
                report.mfu = report.tflops_per_chip / peak.bf16_tflops
                if report.mfu > peaks.SUSPECT_FACTOR:
                    suspect = True
                    why = (f"train MFU {report.mfu:.2f} > "
                           f"{peaks.SUSPECT_FACTOR:g} is impossible; " + why)
        if suspect:
            report.perf_suspect = True
            report.ok = False
            report.error = (report.error + "; " if report.error else "") \
                + f"perf measurement exceeds datasheet peak: {why}"
    except Exception as exc:
        if not report.error:
            report.error = f"microbench skipped: {type(exc).__name__}: {exc}"


def _serve(report: SliceReport, cfg, steps: int, attention, dev,
           mesh=None) -> None:
    """Serving path: first forward, latency percentiles, differenced
    per-forward time, tokens/s; ok iff the logits are finite. On a mesh,
    each rank forwards its (dp, sp) block and tokens/s counts the whole
    batch."""
    from .timing import paired_time
    from .workload import build_infer
    fwd, params, tokens = build_infer(cfg, mesh, attention=attention,
                                      device=dev)

    def run(tok):
        report.forwards += 1
        return fwd(params, tok)

    logits = run(tokens)
    logits[0, 0, 0].item()   # trusted sync
    report.first_step_s = time.monotonic() - _PROCESS_START
    # end-to-end percentiles: submit -> one fetched element
    lat = []
    for _ in range(steps):
        t0 = time.monotonic()
        run(tokens)[0, 0, 0].item()
        lat.append(time.monotonic() - t0)
    lat.sort()
    report.infer_p50_ms = lat[len(lat) // 2] * 1e3
    report.infer_p99_ms = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3

    # per-forward time by chained differencing: each iteration's argmax
    # feeds the next tokens, so the chain cannot overlap or be skipped
    def infer_chain(k):
        def chain(tok):
            for _ in range(k):
                tok = run(tok).argmax(dim=-1)
            return tok.sum()
        return chain

    fwd_s = paired_time(infer_chain, (tokens,), 3, max(steps // 2, 4))
    report.step_time_s = fwd_s if fwd_s > 0 else sum(lat) / len(lat)
    report.tokens_per_s = cfg.batch * cfg.seq_len / report.step_time_s
    # a serving card is usable iff its logits are finite
    report.ok = bool(torch.isfinite(logits).all())
    if not report.ok:
        report.error = "non-finite logits in serving forward"


def _train(report: SliceReport, cfg, steps: int, attention, dev,
           mesh=None, gpipe: int = 0) -> None:
    """Training path: the first step gives `loss_start`; blocks of N and 2N
    steps, each synced by fetching the loss, give the differenced step time
    (the fixed per-fetch cost cancels); ok iff the loss fell. The model
    TFLOP/s are divided over the report's `n_devices`. With `gpipe`
    microbatches the step is the GPipe schedule's (einsum attention, as
    in the JAX probe, whatever `attention` says)."""
    if gpipe:
        from .pipeline import build_gpipe
        step, params, momentum, tokens = build_gpipe(cfg, mesh, gpipe,
                                                     device=dev)
    else:
        from .workload import build_workload
        step, params, momentum, tokens = build_workload(
            cfg, mesh, attention=attention, device=dev)

    def run_step():
        report.steps += 1
        return step(params, momentum, tokens)[2]

    report.loss_start = run_step().item()
    report.first_step_s = time.monotonic() - _PROCESS_START

    def run_block(k):
        t0 = time.monotonic()
        for _ in range(k):
            loss = run_step()
        val = loss.item()
        return time.monotonic() - t0, val

    t_n, _ = run_block(steps)
    t_2n, report.loss_end = run_block(2 * steps)
    # on a noisy host the difference can come out non-positive; then the
    # 2N block's mean (one fetch included), as the serving path falls back
    # to its mean latency
    diff = t_2n - t_n
    report.step_time_s = diff / steps if diff > 0 else t_2n / (2 * steps)
    if report.step_time_s > 0:
        report.tflops_per_chip = (_workload_flops(cfg) / report.step_time_s
                                  / 1e12 / max(report.n_devices, 1))
    # a card that cannot learn is broken even if it computes
    report.ok = report.loss_end < report.loss_start
    if not report.ok:
        report.error = (f"loss did not decrease "
                        f"({report.loss_start:.4f} -> {report.loss_end:.4f})")


# Named model-size presets. "mfu" is the sized-up configuration that
# answers "is it actually fast": d_model 2048, head_dim 128, ffn 4x, seq
# 2048, ~402M params (1.6 GB in f32), ~14 TFLOP per forward.
PRESETS = {
    "burnin": {},  # the ModelConfig defaults: tiny, correctness-first
    "mfu": dict(d_model=2048, n_heads=16, d_ff=8192, n_layers=8,
                seq_len=2048, batch=8),
    # halved d_model/d_ff/heads/layers at the same seq 2048
    "mfu-lite": dict(d_model=1024, n_heads=8, d_ff=4096, n_layers=4,
                     seq_len=2048, batch=8),
}


def _tiles(parser, text: str, flag: str):
    """(block_q, block_k) pairs of a comma-separated 'QxK' list; each must
    be a compiled tile (the kernels' tiles are compile-time constants),
    else the CLI exits 2 before any device is touched."""
    from .attn_bench import check_tiles
    from .flash_attention import BWD_BLOCK, FWD_BLOCK
    try:
        tiles = tuple(tuple(int(x) for x in b.split("x"))
                      for b in text.split(",") if b)
    except ValueError:
        tiles = None
    if tiles is None or any(len(t) != 2 for t in tiles):
        compiled = FWD_BLOCK if flag == "--blocks" else BWD_BLOCK
        parser.error(f"{flag}: {text!r} is not a list of QxK tiles; the "
                     f"compiled one is {compiled[0]}x{compiled[1]}")
    try:
        if flag == "--blocks":
            check_tiles(tiles)
        else:
            check_tiles((), tiles)
    except ValueError as exc:
        parser.error(f"{flag}: {exc}")
    return tiles


def _bench(args, parser) -> int:
    """--mode attn-bench / ring-bench: one JSON line, sorted keys; exit 0
    iff the flash side ran in every cell, 1 on a failure (reported as a
    JSON error line)."""
    if args.gpipe_microbatches:
        parser.error("--gpipe-microbatches only applies to --mode train")
    seqs = tuple(int(s) for s in args.seqs.split(",") if s)
    blocks = _tiles(parser, args.blocks, "--blocks")
    bwd = _tiles(parser, args.bwd_blocks, "--bwd-blocks") or (None,)
    try:
        if args.mode == "ring-bench":
            from .ring_bench import bench_ring
            result = bench_ring(seq_lens=seqs, blocks=blocks, sp=args.sp,
                                hb=args.hb, iters=args.steps,
                                repeats=args.repeats, device=args.device)
            ok = result["ring_flash_ok"]
        else:
            from .attn_bench import bench_attention
            result = bench_attention(seq_lens=seqs, blocks=blocks,
                                     iters=args.steps, hb=args.hb,
                                     bwd_blocks=bwd, repeats=args.repeats,
                                     device=args.device)
            ok = result["flash_ok"]
    except Exception as exc:  # report, don't crash the probe harness
        print(json.dumps({"ok": False,
                          "error": f"{type(exc).__name__}: {exc}"}))
        return 1
    print(json.dumps({"ok": ok, **result}, sort_keys=True))
    return 0 if ok else 1


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="gpu-slice-validator",
        description="Validate a passed-through NVIDIA card from inside the "
                    "guest.")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--mode",
                        choices=["train", "infer", "attn-bench", "ring-bench"],
                        default="train",
                        help="train = SGD steps (step time, TFLOP/s, MFU, "
                             "loss must fall); infer = forward-only serving "
                             "latency percentiles (p50/p99, tokens/s); "
                             "attn-bench = flash kernels vs einsum attention "
                             "on one card; ring-bench = flash ring vs einsum "
                             "ring over --sp ranks (--seqs GLOBAL lengths)")
    parser.add_argument("--seqs", default="1024,2048,4096",
                        help="bench sequence lengths, comma-separated")
    parser.add_argument("--blocks", default="128x128",
                        help="bench forward tiles; only the compiled K1 "
                             "tile, 128x128, exists")
    parser.add_argument("--bwd-blocks", default="",
                        help="attn-bench backward tiles; empty = the "
                             "compiled ones (128x128: K3's query blocks x "
                             "K2's key blocks), the only ones that exist")
    parser.add_argument("--hb", type=int, default=8,
                        help="bench heads*batch (folded leading dim)")
    parser.add_argument("--repeats", type=int, default=1,
                        help="bench: chain this many dependent evaluations "
                             "(scaled by (4096/seq)^2, 8192 for the ring) "
                             "and difference R against 2R")
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="named model size: burnin = tiny defaults, "
                             "mfu = d_model 2048, seq 2048, 8 layers, "
                             "mfu-lite = d_model 1024, 4 layers; "
                             "--seq-len/--experts/--remat compose on top")
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--remat", action="store_true",
                        help="recompute each layer in the backward instead "
                             "of keeping its activations")
    parser.add_argument("--attention",
                        choices=["auto", "flash", "ring", "einsum"],
                        default="auto",
                        help="auto = ring when sp > 1, else the CUDA flash "
                             "kernels on the card from seq FLASH_MIN_SEQ "
                             "(workload.py) and einsum below it and on the "
                             "CPU")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel size (heads and ffn), over "
                             "the slice's cards (every guest's with "
                             "--coordinator)")
    parser.add_argument("--sp", type=int, default=None,
                        help="sequence-parallel size (ring attention), over "
                             "the slice's cards")
    parser.add_argument("--pp", type=int, default=None,
                        help="pipeline stages (the stacked layers cut over a "
                             "pp mesh axis; n_layers %% pp must be 0)")
    parser.add_argument("--ep", type=int, default=None,
                        help="expert-parallel size (use with --experts)")
    parser.add_argument("--experts", type=int, default=None,
                        help="replace the MLP with a top-1 switch MoE of "
                             "this many experts")
    parser.add_argument("--gpipe-microbatches", type=int, default=0,
                        help="train with the GPipe schedule (pipeline.py) "
                             "over this many microbatches; needs --pp > 1 "
                             "and tp == sp == ep == 1")
    # multi-VMI slices: each guest runs the validator with the same
    # coordinator; the guests' cards compose one world (distributed.join)
    # and the mesh spans all of them
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 for a multi-VMI slice")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--init-timeout", type=int, default=60,
                        help="seconds to wait for the multi-VMI rendezvous "
                             "before reporting failure (default 60)")
    args = parser.parse_args(argv)
    if args.coordinator is None:
        return _dispatch(args, parser, None)
    start = time.monotonic()
    try:
        world = join_slice(args.coordinator, args.num_processes,
                           args.process_id, args.init_timeout, args.device)
    except Exception as exc:  # report, don't crash the probe harness
        # an unreachable coordinator too: the store's connect times out
        # and raises (the JAX probe's coordination client aborts there)
        print(SliceReport(ok=False, rendezvous_s=time.monotonic() - start,
                          error=f"distributed init: {type(exc).__name__}: "
                                f"{exc}").to_json())
        return 1
    with world:
        return _dispatch(args, parser, world)


def _dispatch(args, parser, world) -> int:
    """The mode: a bench on this guest's own cards, or the validation of
    the slice (`world`'s when joined)."""
    if args.mode in ("attn-bench", "ring-bench"):
        return _bench(args, parser)
    from .workload import ModelConfig
    overrides = dict(PRESETS.get(args.preset or "", {}))
    if args.seq_len is not None:
        overrides["seq_len"] = args.seq_len
    if args.experts is not None:
        overrides["n_experts"] = args.experts
    if args.remat:
        overrides["remat"] = True
    cfg = ModelConfig(**overrides)
    # pp and ep against the model, as the JAX probe checks them, before
    # any device is touched: a caller's error, never a broken slice
    if args.pp and args.pp > 1 and cfg.n_layers % args.pp:
        parser.error(f"--pp {args.pp} does not divide n_layers={cfg.n_layers}")
    if args.ep and args.ep > 1:
        if not cfg.n_experts:
            parser.error(f"--ep {args.ep} needs --experts (dense model has "
                         "no expert dimension to shard)")
        if cfg.n_experts % args.ep:
            parser.error(f"--ep {args.ep} does not divide "
                         f"--experts {cfg.n_experts}")
    if args.gpipe_microbatches:
        if args.mode != "train":
            parser.error("--gpipe-microbatches only applies to --mode train")
        if (args.pp or 0) < 2:
            parser.error("--gpipe-microbatches needs --pp >= 2")
        if (args.tp or 1) != 1 or (args.sp or 1) != 1 or (args.ep or 1) != 1:
            parser.error("--gpipe-microbatches needs tp == sp == ep == 1")
        if args.attention != "auto":
            parser.error("the GPipe schedule runs einsum attention; "
                         "drop --attention")
        if cfg.batch % args.gpipe_microbatches:
            parser.error(f"batch {cfg.batch} not divisible by "
                         f"--gpipe-microbatches {args.gpipe_microbatches}")
    attention = None if args.attention == "auto" else args.attention
    report = validate_slice(cfg=cfg, steps=args.steps, attention=attention,
                            mode=args.mode, device=args.device, tp=args.tp,
                            sp=args.sp, pp=args.pp, ep=args.ep,
                            gpipe_microbatches=args.gpipe_microbatches,
                            world=world)
    print(report.to_json())
    if report.invalid_config:
        return 2  # caller error, not a broken card
    return 0 if report.ok else 1
