#!/usr/bin/env python3
"""Where one step of the PyTorch port spends its time on one CUDA card.

    python3 scripts/profile_torch_step.py [--mode train|infer] [--preset mfu]
                                          [--experts N] [--steps 3]
                                          [--trace out.json]

Builds the port's training step (`build_workload`) or serving forward
(`build_infer`) with flash attention (with `--experts`, the top-1 switch
MoE of that many experts), runs two warm-up steps, then `--steps`
steps under `torch.profiler` (CPU and CUDA activities), synchronised at
the end. Prints one JSON object:

- `wall_ms_per_step`: host clock over the profiled steps, per step;
- `device_busy_ms_per_step`: the union of all kernel and memcpy intervals
  on the card, per step; `device_idle_share` = 1 - busy / wall;
- `device_ms_per_step`: kernel time per step grouped as K1 (`flash_fwd`),
  K2 (`flash_bwd_dkv`), K3 (`flash_bwd_dq`), `gemm` (cuBLAS matmuls) and
  `other` (elementwise, reductions, casts, copies), and `top_kernels`.

Needs a CUDA card; exits non-zero without one. The profiler's own cost is
inside `wall_ms_per_step`, so compare it with `step_time_s` of an
unprofiled run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# kernel-name marks: each kernel's scalar (f32) and tensor-core (bf16)
# instances share them
GROUPS = (("flash_fwd", "flash_fwd_"),
          ("flash_bwd_dkv", "flash_bwd_dkv_"),
          ("flash_bwd_dq", "flash_bwd_dq_"))
GEMM_MARKS = ("gemm", "sm90_xmma", "cutlass", "cublas", "nvjet")


def _group(name: str) -> str:
    for group, mark in GROUPS:
        if mark in name:
            return group
    low = name.lower()
    return "gemm" if any(m in low for m in GEMM_MARKS) else "other"


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mode", choices=["train", "infer"], default="train")
    parser.add_argument("--preset", default="mfu")
    parser.add_argument("--experts", type=int, default=0)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--trace", default=None,
                        help="also write a Chrome trace to this path")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_step: CUDA is not available", file=sys.stderr)
        return 1
    from tpu_device_plugin_torch.validator import workload
    from tpu_device_plugin_torch.validator.probe import PRESETS
    cfg = workload.ModelConfig(**PRESETS[args.preset],
                               n_experts=args.experts)
    if args.mode == "train":
        step, params, momentum, tokens = workload.build_workload(
            cfg, attention="flash", device="cuda")

        def run():
            return step(params, momentum, tokens)[2]
    else:
        fwd, params, tokens = workload.build_infer(cfg, attention="flash",
                                                   device="cuda")

        def run():
            return fwd(params, tokens)[0, 0, 0]

    for _ in range(2):
        run().item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(args.steps):
            run()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_group, by_name, intervals = defaultdict(float), defaultdict(float), []
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = evt.time_range.end - evt.time_range.start
        intervals.append((evt.time_range.start, evt.time_range.end))
        by_group[_group(evt.name)] += dur
        by_name[evt.name] += dur
    n = args.steps
    busy_ms = _union_us(intervals) / 1e3 / n if intervals else None
    wall_ms = wall_s * 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "mode": args.mode, "preset": args.preset,
        "n_experts": args.experts, "steps": n,
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
        "device_ms_per_step": {g: us / 1e3 / n for g, us in
                               sorted(by_group.items())},
        "top_kernels": [{"name": name[:120], "ms_per_step": us / 1e3 / n}
                        for name, us in top],
    }))
    return 0 if intervals else 1


if __name__ == "__main__":
    sys.exit(main())
