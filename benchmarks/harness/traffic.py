"""The one traffic generator: reads a mix file's parameters, makes a plan.

A mix is a JSON file of parameters (`benchmarks/mixes/<traffic>.json`):

- `{"kind": "train", "batch": B, "seq": S, "pool": P, "followed": F}`: a
  closed loop of training steps on (B, S) batches of tokens uniform over
  the vocab. P distinct batches are made on the device and taken in
  turn; the first F (3 where the key is left out) are the steps that the
  reference follows.
- `{"kind": "score", "batch": B, "length": {...}, "cycle": K,
  "sample": N}`: a closed loop of one client scoring requests of B prompts
  of one length L each. `length` gives a lognormal (`median`, `sigma`),
  clipped to [`min`, `max`] and rounded up to a multiple of `multiple`.
  Every seed gets the same K lengths, the lognormal's quantiles at
  (i + 0.5) / K, and each run of K requests takes them in an order drawn
  from the seed: a window holds the same work whatever the seed. N
  requests of the first K, the longest and the shortest among them (so
  both of the port's attention modes are checked where the lengths span
  its switch), are the ones the reference checks.

`report` maps the quantities a run of the kind measures (`tokens_per_s`;
scoring also `p95_ms`) to the end-to-end metrics they are reported under.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List

import numpy as np
import torch

from .inputs import generator, subseed


def cycle_lengths(length: dict, count: int) -> List[int]:
    """The K lengths of one cycle, sorted: lognormal quantiles, clipped and
    rounded up to the multiple."""
    dist = NormalDist(math.log(length["median"]), length["sigma"])
    step = length["multiple"]
    out = []
    for i in range(count):
        raw = math.exp(dist.inv_cdf((i + 0.5) / count))
        rounded = math.ceil(raw / step) * step
        out.append(int(min(length["max"], max(length["min"], rounded))))
    return sorted(out)


@dataclass
class Plan:
    kind: str
    batch: int
    seed: int
    seq: int = 0                     # train
    pool: torch.Tensor = None        # train: (P, B, S) on the device
    cycle: List[int] = field(default_factory=list)   # score
    sample: List[int] = field(default_factory=list)  # score
    _host: torch.Tensor = None       # score: one prompt buffer per slot
    _orders: Dict[int, np.ndarray] = field(default_factory=dict)

    def batch_tokens(self, i: int) -> torch.Tensor:
        """Training step i's token batch (on the device)."""
        return self.pool[i % self.pool.shape[0]]

    def length(self, i: int) -> int:
        """Scoring request i's prompt length."""
        k = len(self.cycle)
        c = i // k
        if c not in self._orders:
            self._orders[c] = np.random.default_rng(
                subseed(self.seed, f"cycle:{c}")).permutation(k)
        return self.cycle[self._orders[c][i % k]]

    def shapes(self) -> List[int]:
        """The distinct request lengths, longest first."""
        return sorted(set(self.cycle), reverse=True)

    def prompt(self, i: int) -> torch.Tensor:
        """Request i's (B, L) prompts in host memory (pinned on a CUDA
        run), contiguous, for the copy that submits the request."""
        n = self.batch * self.length(i)
        slot = self._host[i % self._host.shape[0]]
        return slot[:n].view(self.batch, -1)


def make_plan(mix: dict, model: dict, seed: int, device) -> Plan:
    device = torch.device(device)
    vocab = model["vocab"]
    if mix["kind"] == "train":
        b, s, p = mix["batch"], mix["seq"], mix["pool"]
        pool = torch.randint(0, vocab, (p, b, s), device=device,
                             generator=generator(seed, "tokens", device))
        return Plan("train", b, seed, seq=s, pool=pool)
    if mix["kind"] != "score":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    k, b = mix["cycle"], mix["batch"]
    cycle = cycle_lengths(mix["length"], k)
    host = torch.randint(0, vocab, (k, b * max(cycle)),
                         generator=generator(seed, "prompts", "cpu"))
    if device.type == "cuda":
        host = host.pin_memory()
    plan = Plan("score", b, seed, cycle=cycle, _host=host)
    first = [plan.length(i) for i in range(k)]
    ends = {first.index(max(first)), first.index(min(first))}
    others = [i for i in range(k) if i not in ends]
    drawn = np.random.default_rng(subseed(seed, "sample")).choice(
        others, size=min(mix["sample"] - len(ends), len(others)),
        replace=False)
    plan.sample = sorted([*ends, *map(int, drawn)])
    return plan
