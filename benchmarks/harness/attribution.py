"""A traced window's device time, placed under the port's spans by launch.

The port records spans of its own while a caller holds its recording open
(`tpu_device_plugin_torch/validator/tracing.py`): each with a name, a
start and an end on `time.time_ns()`, the clock of the profiler's
timestamps, the POSIX id of its thread (`threading.get_ident()`), and its
parent on that thread. CUPTI records, beside each kernel, memcpy and
memset on the card, the CUDA API call (`cuda*` or `cu*`) that launched
it, with the same correlation id, the host time of the call and the
calling thread's POSIX id cut to its low 32 bits (the event's
`device_resource_id()`, a signed 32-bit value: both sides are compared as
unsigned). So each piece of device work is placed where the host asked
for it:

- under the innermost port span open on the launching thread when the
  call was made: its name is the bucket;
- `outside` where no port span was open on that thread;
- `unmatched` where no launch record carries its correlation id.

Backward work is launched from the autograd engine's thread, where the
port brackets each module's backward in a span of the module's name plus
`.bwd`. `module_ms` folds the buckets into the port's modules, a step or
request's device time of one kernel group (trace.py's groups) or of all.

Nothing here imports the port: spans are any objects with `name`,
`start_ns`, `end_ns`, `thread` and `parent` (an index into the same list,
or None).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .trace import DEVICE_ACTIVITIES, group

LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")
THREAD_BITS = 0xFFFFFFFF
OUTSIDE, UNMATCHED = "outside", "unmatched"
# the port's modules (tracing spans), forward and backward
MODULES = {"attention": "workload.attention", "ffn": "workload.ffn",
           "head": "workload.head", "sgd": "workload.sgd_update"}
ROOTS = ("workload.sgd_step", "workload.forward")


@dataclass
class Launches:
    """The window's device work with its correlation ids, and every
    CUDA API call by correlation id: (host start, thread)."""
    device: List[Tuple[str, int, int, int]] = field(default_factory=list)
    calls: Dict[int, Tuple[int, int]] = field(default_factory=dict)


def read_launches(raw, window: Tuple[int, int]) -> Launches:
    """From the profiler's raw events: the kernels, memcpys and memsets
    that `trace.read_events` keeps, clipped to the window as there, each
    with the correlation id of its launch; and the launch calls, the
    CUDA API calls that `LAUNCH_CALLS` names (the profiler's
    own host records, such as its buffer requests, may repeat a launch's
    correlation id). A device event carries the id in
    `linked_correlation_id()` or, where that is 0, `correlation_id()`."""
    lo, hi = window
    out = Launches()
    cuda = torch.autograd.DeviceType.CUDA
    for evt in raw:
        if evt.device_type() == cuda:
            if (hasattr(evt, "activity_type")
                    and evt.activity_type() not in DEVICE_ACTIVITIES):
                continue
            s = evt.start_ns()
            e = s + evt.duration_ns()
            if e > lo and s < hi:
                out.device.append((evt.name(), max(s, lo), min(e, hi),
                                   evt.linked_correlation_id()
                                   or evt.correlation_id()))
        elif evt.name().startswith(LAUNCH_CALLS):
            out.calls[evt.correlation_id()] = (
                evt.start_ns(), evt.device_resource_id() & THREAD_BITS)
    return out


class _Placer:
    """The innermost span open at a time on a thread: spans of one thread
    nest, so it is the latest begun at or before that time, or the nearest
    of its ancestors still open then."""

    def __init__(self, spans: Sequence):
        self.spans = spans
        by_thread: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for i, s in enumerate(spans):
            by_thread[s.thread & THREAD_BITS].append((s.start_ns, i))
        self.starts, self.order = {}, {}
        for thread, opened in by_thread.items():
            opened.sort()
            self.starts[thread] = [start for start, _ in opened]
            self.order[thread] = [i for _, i in opened]

    def innermost(self, thread: int, t: int) -> Optional[int]:
        starts = self.starts.get(thread)
        if not starts:
            return None
        k = bisect.bisect_right(starts, t) - 1
        i = self.order[thread][k] if k >= 0 else None
        while i is not None and self.spans[i].end_ns < t:
            i = self.spans[i].parent
        return i


@dataclass
class Placed:
    """Device ns by bucket and kernel name, and the checks of the join."""
    ns: Dict[Tuple[str, str], int]
    matched_share: float        # of device time: a launch record found
    in_root_share: float        # of matched launches: host time inside a
    #                             root span's interval, on any thread
    bwd_share: Optional[float]  # of `other` time launched from the
    #                             autograd thread (one with `.bwd` spans
    #                             and no root span): under a `.bwd` span

    def by_bucket(self, kernel_group: Optional[str] = None) -> Dict[str, int]:
        out: Dict[str, int] = defaultdict(int)
        for (bucket, name), ns in self.ns.items():
            if kernel_group is None or group(name) == kernel_group:
                out[bucket] += ns
        return dict(out)


def place(launches: Launches, spans: Sequence) -> Placed:
    """Each piece of device work under the span that launched it."""
    placer = _Placer(spans)
    roots = sorted((s.start_ns, s.end_ns) for s in spans if s.name in ROOTS)
    root_starts = [s for s, _ in roots]
    bwd_threads = ({s.thread & THREAD_BITS for s in spans
                    if s.name.endswith(".bwd")}
                   - {s.thread & THREAD_BITS for s in spans
                      if s.name in ROOTS})
    ns: Dict[Tuple[str, str], int] = defaultdict(int)
    total = matched = calls = in_root = 0
    bwd_other = bwd_under = 0
    for name, s, e, corr in launches.device:
        dt = e - s
        total += dt
        call = launches.calls.get(corr)
        if call is None:
            ns[(UNMATCHED, name)] += dt
            continue
        matched += dt
        host, thread = call
        calls += 1
        k = bisect.bisect_right(root_starts, host) - 1
        in_root += k >= 0 and roots[k][1] >= host
        i = placer.innermost(thread, host)
        bucket = OUTSIDE if i is None else spans[i].name
        ns[(bucket, name)] += dt
        if thread in bwd_threads and group(name) == "other":
            bwd_other += dt
            bwd_under += dt if _under_bwd(spans, i) else 0
    return Placed(dict(ns), matched / total if total else 0.0,
                  in_root / calls if calls else 0.0,
                  bwd_under / bwd_other if bwd_other else None)


def _under_bwd(spans, i: Optional[int]) -> bool:
    while i is not None:
        if spans[i].name.endswith(".bwd"):
            return True
        i = spans[i].parent
    return False


def module_of(bucket: str) -> str:
    """The port module a bucket belongs to: a module span forward or
    `.bwd`, `root` for device work under a root span alone, else the
    bucket (`outside`, `unmatched`, any other span)."""
    name = bucket[:-len(".bwd")] if bucket.endswith(".bwd") else bucket
    for module, span_name in MODULES.items():
        if name == span_name:
            return module
    return "root" if name in ROOTS else bucket


def module_ms(placed: Placed, units: int,
              kernel_group: Optional[str] = None) -> Dict[str, float]:
    """ms a step or request by module, of one kernel group or of all."""
    out: Dict[str, float] = defaultdict(float)
    for bucket, ns in placed.by_bucket(kernel_group).items():
        out[module_of(bucket)] += ns / 1e6 / units
    return dict(out)


def top_kernels(placed: Placed, units: int, kernel_group: str = "other",
                n: int = 6) -> Dict[str, List[list]]:
    """By module, its `n` largest kernels of one group: [name, ms a unit]."""
    by: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for (bucket, name), ns in placed.ns.items():
        if group(name) == kernel_group:
            by[module_of(bucket)][name] += ns
    return {module: [[name[:120], ns / 1e6 / units] for name, ns in
                     sorted(kernels.items(), key=lambda kv: -kv[1])[:n]]
            for module, kernels in by.items()}
