"""Device-timing helpers: the probe's differencing estimator, in PyTorch.

Port of `tpu_device_plugin/validator/timing.py` with the same contract.
CUDA work is asynchronous, so the only sync this module trusts is
fetching a data-dependent scalar to the host (`.item()`), which waits for
everything the scalar depends on.

The methodology: chain R serially-dependent iterations into one scalar,
time the fetch at R and 2R, and divide the difference by R — the fixed
per-fetch cost (launch of the first kernel, the device-to-host copy)
cancels. The R and 2R runs are sampled as interleaved pairs and the
estimate is the median of the per-pair differences, so a load spike
perturbs one pair rather than the estimate. With a minimum differenced
time, R grows until R iterations stand clear of the host's jitter.

PyTorch has no `jit`: a "chain" is a Python loop of eager calls, so at a
toy size the estimate includes the per-iteration launch overhead, which
is real cost for an eager caller.
"""

from __future__ import annotations

import time
from typing import List, Sequence


def median(xs: Sequence[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2]


def time_total(fn, args, iters: int) -> float:
    """Median wall-clock seconds per call, after one warmup call.

    `fn(*args)` must return a scalar tensor depending on the full
    computation; `.item()` fetches it (the trusted sync)."""
    samples: List[float] = []
    fn(*args).item()   # warmup (first-use kernel builds, allocator growth)
    for _ in range(max(iters, 1)):
        samples.append(_timed(fn, args))
    return median(samples)


def _timed(fn, args) -> float:
    t0 = time.monotonic()
    fn(*args).item()
    return time.monotonic() - t0


def paired_time(build, args, iters: int, repeats: int,
                min_diff_s: float = 0.0, max_repeats: int = 65536) -> float:
    """Per-iteration seconds via paired-repeats differencing.

    `build(k)` returns a fn of `args` chaining k dependent iterations into
    one scalar tensor. repeats<=1 (with no floor) falls back to plain
    per-call timing. With `min_diff_s` > 0 the chain length grows until the
    differenced time reaches the floor; the estimate is the median of
    interleaved per-pair differences."""
    if repeats <= 1 and min_diff_s <= 0:
        return time_total(build(1), args, iters)
    repeats = max(repeats, 1)
    while True:
        fn1, fn2 = build(repeats), build(2 * repeats)
        fn1(*args).item()   # warm both chain lengths
        fn2(*args).item()
        if min_diff_s <= 0 or repeats >= max_repeats:
            break
        d = _timed(fn2, args) - _timed(fn1, args)
        if d >= min_diff_s:
            break
        # grow toward the floor in one jump when the probe pair gives a
        # usable signal, else double
        grow = max(2, min(64, int(min_diff_s / d) + 1)) if d > 0 else 2
        repeats = min(max_repeats, repeats * grow)
    diffs: List[float] = []
    for _ in range(max(iters, 1)):
        t1 = _timed(fn1, args)
        t2 = _timed(fn2, args)
        diffs.append((t2 - t1) / repeats)
    return max(median(diffs), 0.0)
