"""The traced run: `torch.profiler` over the window, and what is read from it.

Device work is every kernel, memcpy and memset on the card, read from the
profiler's raw event list (no per-event Python objects are built: a
window holds hundreds of thousands of events). The profiler traces the
card alone (CUPTI activity records); host-side op recording is left off,
since at one record per eager op it slowed the host-bound scoring loop by
half and so read as device idle time. What the host does is marked by the
benchmark's own spans instead, taken on `time.time_ns()`, the clock the
profiler's timestamps are given in: `bench.make_inputs`,
`bench.enqueue_step`, `bench.enqueue_request`, `bench.sync`,
`bench.keep_answer`, and `bench.window` around the whole measured window.

Kernels are grouped by a mark in their names: the port's flash attention
kernels K1 `flash_fwd`, K2 `flash_bwd_dkv` and K3 `flash_bwd_dq`; `gemm`,
the matmuls and matrix-vector products of cuBLAS and CUTLASS; and
`other`, everything else (norms, activations, casts, copies, the MoE
dispatch, the loss, the SGD update).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

GROUPS = (("flash_fwd", "flash_fwd_"),
          ("flash_bwd_dkv", "flash_bwd_dkv_"),
          ("flash_bwd_dq", "flash_bwd_dq_"))
GEMM_MARKS = ("gemm", "gemv", "sm90_xmma", "cutlass", "cublas", "nvjet")
FLASH = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


def group(name: str) -> str:
    for name_group, mark in GROUPS:
        if mark in name:
            return name_group
    low = name.lower()
    return "gemm" if any(m in low for m in GEMM_MARKS) else "other"


def union_ns(intervals) -> int:
    total, end = 0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


class Tracer:
    """Spans, and the profiler on a CUDA device, only when `enabled`."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.spans: List[Tuple[str, int, int]] = []
        self._prof = None
        if enabled and device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def _span(self, name: str):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return self._span(name)

    def events(self) -> "Events":
        raw = (self._prof.profiler.kineto_results.events()
               if self._prof is not None else [])
        return read_events(raw, self.spans)


@dataclass
class Events:
    window: Tuple[int, int]
    device: List[Tuple[str, int, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_ns(self) -> int:
        return self.window[1] - self.window[0]

    def busy_ns(self) -> int:
        return union_ns((s, e) for _, s, e in self.device)

    def time_by_group(self) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device:
            out[group(name)] += e - s
        return out

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, int] = defaultdict(int)
        for name, s, e in self.device:
            by_name[name] += e - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle device time in the window, summed by the host span that
        covers each gap's middle (the innermost, the latest begun)."""
        gaps, end = [], self.window[0]
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        spans = sorted((s, e, name) for name, s, e in self.spans
                       if name != WINDOW)
        starts = [s for s, _, _ in spans]
        by_label: Dict[str, int] = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            covered = i >= 0 and spans[i][1] >= mid
            by_label[spans[i][2] if covered else "no span"] += e - s
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
        return [[label, ns / 1e9] for label, ns in top]


def read_events(raw, spans) -> Events:
    """Device work from the profiler's raw events, clipped to the
    `bench.window` span."""
    window = next((s, e) for name, s, e in spans if name == WINDOW)
    lo, hi = window
    device = []
    cuda = torch.autograd.DeviceType.CUDA
    for evt in raw:
        if evt.device_type() != cuda or (
                hasattr(evt, "activity_type")
                and evt.activity_type() not in DEVICE_ACTIVITIES):
            continue
        s = evt.start_ns()
        e = s + evt.duration_ns()
        if e > lo and s < hi:
            device.append((evt.name(), max(s, lo), min(e, hi)))
    return Events(window, device, list(spans))
