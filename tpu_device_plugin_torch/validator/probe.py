"""Slice validation probe on an NVIDIA card: the serving path.

Port of `tpu_device_plugin/validator/probe.py`, `--mode infer`: process
start → CUDA device enumerated → first forward done, then serving latency
percentiles, tokens/s, and a matmul/memory microbench checked against the
card's datasheet peak. Exit code is non-zero when the card is unusable, so
a VMI startup probe can gate workload admission on it. Training, the mesh
and the benches are later slices (ROADMAP.md, Queue 1).
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
    first_step_s: float = 0.0        # process start -> first forward done
    step_time_s: float = 0.0         # steady-state forward latency
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
    # forward passes this validation ran (each launches the attention
    # kernel once per layer in flash mode)
    forwards: int = 0
    # True when the failure is the CALLER's configuration, not a broken
    # card — probes gating VMI admission must not treat it as hardware
    invalid_config: bool = False
    error: str = ""

    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)


# Minimum differenced compute time (seconds) for a trustworthy microbench
# reading on the card: host jitter is ~ms-scale, so the signal must stand
# ~100x above it. timing.paired_time grows the chain length to reach it.
MICROBENCH_MIN_DIFF_S = 0.25


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
        min_diff_s = MICROBENCH_MIN_DIFF_S if on_gpu else 0.0
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


def validate_slice(cfg=None, steps: int = 20, attention: Optional[str] = None,
                   mode: str = "infer", device=None) -> SliceReport:
    """Serving-path validation of one card (`device`, CUDA by default)."""
    report = SliceReport(ok=False)
    if mode != "infer":
        report.invalid_config = True
        report.error = (f"mode {mode!r} is not yet ported (ROADMAP.md, "
                        "Queue 1); only 'infer' runs")
        return report
    try:
        from .timing import paired_time
        from .workload import ModelConfig, build_infer, resolve_device
        dev = resolve_device(device)
        report.devices_visible_s = time.monotonic() - _PROCESS_START
        if dev.type == "cuda":
            report.platform = "gpu"
            report.n_devices = torch.cuda.device_count()
            report.device_kinds = [torch.cuda.get_device_name(dev)]
        else:
            report.platform = dev.type
            report.n_devices = 1
            report.device_kinds = [dev.type]
        cfg = cfg or ModelConfig()
        steps = max(steps, 1)  # percentiles need >=1 sample
        fwd, params, tokens = build_infer(cfg, attention=attention, device=dev)

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

        # Microbench + physics check after the verdict. A card slower than
        # peak is diagnostic-only; a card MEASURING FASTER than its
        # datasheet peak is a broken estimator and vetoes the run.
        try:
            report.matmul_tflops, report.hbm_gbps = _microbench(dev)
            from . import peaks
            kind = report.device_kinds[0]
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
            if suspect:
                report.perf_suspect = True
                report.ok = False
                report.error = (report.error + "; " if report.error else "") \
                    + f"perf measurement exceeds datasheet peak: {why}"
        except Exception as exc:
            if not report.error:
                report.error = f"microbench skipped: {type(exc).__name__}: {exc}"
    except Exception as exc:  # report, don't crash the probe harness
        report.error = f"{type(exc).__name__}: {exc}"
    return report


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

# what the CLI refuses until its slice lands, and the ROADMAP.md item that
# brings it
_NOT_PORTED_MODES = {
    "train": "Queue 1, item 2 (training slice)",
    "attn-bench": "Queue 1, item 7 (benches)",
    "ring-bench": "Queue 1, item 7 (benches)",
}
_MESH_FLAGS = ("tp", "sp", "pp", "ep")


def main(argv=None) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="gpu-slice-validator",
        description="Validate a passed-through NVIDIA card from inside the "
                    "guest (serving path).")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--mode", choices=["infer", *_NOT_PORTED_MODES],
                        default="infer",
                        help="infer = forward-only serving latency "
                             "percentiles (p50/p99, tokens/s); the other "
                             "modes are not ported yet")
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="named model size: burnin = tiny defaults, "
                             "mfu = d_model 2048, seq 2048, 8 layers, "
                             "mfu-lite = d_model 1024, 4 layers")
    parser.add_argument("--seq-len", type=int, default=None)
    parser.add_argument("--attention", choices=["auto", "flash", "einsum"],
                        default="auto",
                        help="auto = the CUDA flash kernel on the card, "
                             "einsum on the CPU")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    for flag in _MESH_FLAGS:
        parser.add_argument(f"--{flag}", type=int, default=None,
                            help="mesh axis size: not ported yet")
    args = parser.parse_args(argv)
    if args.mode in _NOT_PORTED_MODES:
        parser.error(f"--mode {args.mode} is not yet ported "
                     f"(ROADMAP.md, {_NOT_PORTED_MODES[args.mode]})")
    for flag in _MESH_FLAGS:
        if getattr(args, flag) is not None:
            parser.error(f"--{flag}: the mesh is not yet ported "
                         "(ROADMAP.md, Queue 1, item 3)")
    cfg = None
    if args.preset is not None or args.seq_len is not None:
        from .workload import ModelConfig
        overrides = dict(PRESETS.get(args.preset or "", {}))
        if args.seq_len is not None:
            overrides["seq_len"] = args.seq_len
        cfg = ModelConfig(**overrides)
    attention = None if args.attention == "auto" else args.attention
    report = validate_slice(cfg=cfg, steps=args.steps, attention=attention,
                            mode=args.mode, device=args.device)
    print(report.to_json())
    if report.invalid_config:
        return 2  # caller error, not a broken card
    return 0 if report.ok else 1
