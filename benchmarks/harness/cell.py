"""One run of one cell: set-up, the measured window, then the check.

Training: set-up makes the weights, the zero momentum and the token
batches from the seed, and drives the port's step through its first
steps (three, or the mix's `followed`), which compile and warm up
everything the window runs. What the check compares is read from the
port's state on the way: the losses, the momentum after step 1 (the first
gradient as the optimizer holds it), and the parameters' change after the
last followed step, before the next moves them. The window then runs the
steps after those, each synced on its loss, until
`seconds` have passed; `tokens_per_s` is all their tokens over all that
time.

Scoring: set-up makes the weights and the prompts, and scores one request
of each length the mix uses. The window is a closed loop of one client:
each request is timed from the copy of its prompts out of pinned host
memory to the logits complete on the card (`torch.cuda.synchronize()`);
`p95_ms` is the 95th percentile of every request of the window and
`tokens_per_s` all their prompt tokens over the window's time. The
sampled requests' answers (traffic.py) are kept after their timing ends.
The mix's `report` names the end-to-end metric each quantity is reported
under.

`setup_s` runs from the process's start to the window's and is timed by
its parts (Laps), each synced on the card: `imports`, `cuda_context`,
`port_import`, `weights`, `inputs`, `first_step` (the first step or
request, which loads the port's kernel library and every library kernel
it touches), `warmup` (the rest of the warm-up) and `profiler` (starting
the trace). run.py prints them on standard error.

After the window: the peak memory is read, the port's state is freed, and
the reference of the configuration's definition (block.py), from the same
seed and inputs, decides `correct`.
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checks
from .inputs import flatten, make_leaf, make_params, nest
from .metrics import View
from .peaks import lookup
from .program import Port
from .trace import WINDOW, Tracer
from .traffic import make_plan

FOLLOWED_STEPS = 3


@dataclass
class Outcome:
    result: dict                      # the result line, `checks` last
    numbers: Dict[str, float] = field(default_factory=dict)
    # set-up's parts (`setup.<part>`), and what follows the window
    seconds: Dict[str, float] = field(default_factory=dict)
    detail: dict = field(default_factory=dict)   # the widest leaves (training)

    @property
    def correct(self) -> bool:
        return self.result["correct"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Laps:
    """Set-up timed by its parts: each mark records the seconds since the
    one before (the first since `t0`, the process's start), so the parts
    add up to `setup_s`. Each part ends synced on the card."""

    def __init__(self, t0: float, device: torch.device):
        self.last, self.device, self.parts = t0, device, {}

    def mark(self, part: str, sync: bool = True) -> float:
        if sync:
            _sync(self.device)
        now = time.perf_counter()
        self.parts[part] = now - self.last
        self.last = now
        return now


def follow(step, steps: int, params: Dict[str, torch.Tensor],
           momentum: Dict[str, torch.Tensor], definition, model: dict,
           seed: int, device) -> dict:
    """Drive `step(i) -> loss` through the `steps` followed steps and read
    what the check compares from the state: flat `params` and `momentum`
    are views of the state that `step` updates in place."""
    losses, grad = [], {}
    for i in range(steps):
        losses.append(step(i).item())
        if i == 0:
            grad = checks.leaf_norms(momentum)
    update: Dict[str, float] = {}
    for name, p in params.items():
        start = make_leaf(definition, model, name, seed, device)
        update.update(checks.leaf_norms({name: p - start}))
        del start
    return {"losses": losses, "grad": grad, "update": update}


def train_reference(definition, model: dict, seed: int, device, batches,
                    routes: list) -> dict:
    """The definition's f32 reference through the followed steps, on the
    same weights and batches; a block that routes follows the routes the
    program recorded."""
    params = {n: make_leaf(definition, model, n, seed, device)
              for n in definition.leaf_shapes(model)}
    momentum = {n: torch.zeros_like(p) for n, p in params.items()}
    given = [None if r is None
             else definition.new_routes(model, r.by_layer, follow=True)
             for r in routes]
    out = follow(lambda i: definition.sgd_step(params, momentum, batches[i],
                                               model, "f32", given[i]),
                 len(batches), params, momentum, definition, model, seed,
                 device)
    if routes[0] is not None:
        out["route_gap"] = max(r.gap for r in given)
    del params, momentum
    _free(torch.device(device))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        port: Optional[Port] = None, ref_cache: Optional[dict] = None
        ) -> Outcome:
    device = torch.device(device)
    laps = Laps(t0, device)
    laps.mark("imports", sync=False)
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
        laps.mark("cuda_context")
    port = port or Port(cell.definition, cell.model, device)
    laps.mark("port_import")
    tracer = Tracer(trace, device)
    kind = cell.mix["kind"]
    if kind == "train":
        window = _train(cell, seed, seconds, device, laps, port, tracer,
                        ref_cache)
    else:
        window = _score(cell, seed, seconds, device, laps, port, tracer)
    window["setup_s"] = window["start"] - t0
    window["setup_parts"] = laps.parts
    return _outcome(cell, trace, device, tracer, window)


def _train(cell, seed, seconds, device, laps, port, tracer, ref_cache):
    model, definition = cell.model, cell.definition
    params = make_params(definition, model, seed, device)
    momentum = nest({n: torch.zeros_like(p)
                     for n, p in flatten(params).items()})
    laps.mark("weights")
    plan = make_plan(cell.mix, model, seed, device)
    followed = cell.mix.get("followed", FOLLOWED_STEPS)
    routes = [definition.new_routes(model) for _ in range(followed)]
    laps.mark("inputs")

    def step(i):
        loss = port.step(params, momentum, plan.batch_tokens(i), routes[i])
        if i == 0:
            laps.mark("first_step")
        return loss

    got = follow(step, followed, flatten(params), flatten(momentum),
                 definition, model, seed, device)
    laps.mark("warmup")
    b, s = plan.batch, plan.seq
    losses: List[float] = []
    with tracer:
        start = laps.mark("profiler")
        with tracer.span(WINDOW):
            i = followed
            while True:
                with tracer.span("bench.enqueue_step"):
                    loss = port.step(params, momentum, plan.batch_tokens(i))
                with tracer.span("bench.sync"):
                    losses.append(loss.item())
                i += 1
                if time.perf_counter() - start >= seconds:
                    break
        end = time.perf_counter()
    steps = len(losses)
    window = dict(start=start, window_s=end - start,
                  peak=_peak(device), attempted=steps,
                  failed=sum(not math.isfinite(v) for v in losses),
                  units=[(b, s, port.attention(b, s))] * steps,
                  rates={"tokens_per_s": steps * b * s / (end - start)})
    batches = [plan.batch_tokens(i).clone() for i in range(followed)]
    del params, momentum, plan, loss
    for r in routes:
        if r is not None:
            r.by_layer = {k: v.clone() for k, v in r.by_layer.items()}
    _free(device)
    began = time.perf_counter()
    # a reference that follows this run's routes: nothing to share
    key = None if routes[0] is not None else (cell.name, seed)
    ref = (ref_cache or {}).get(key)
    if ref is None:
        ref = train_reference(definition, model, seed, device, batches,
                              routes)
        if ref_cache is not None and key is not None:
            ref_cache[key] = ref
    window["numbers"] = checks.train_numbers(got, ref)
    window["detail"] = checks.worst_leaves(got, ref)
    window["reference_s"] = time.perf_counter() - began
    return window


def _score(cell, seed, seconds, device, laps, port, tracer):
    model, definition = cell.model, cell.definition
    params = make_params(definition, model, seed, device)
    laps.mark("weights")
    plan = make_plan(cell.mix, model, seed, device)
    b = plan.batch
    laps.mark("inputs")

    def request(i):
        with tracer.span("bench.make_inputs"):
            tokens = plan.prompt(i).to(device, non_blocking=True)
        with tracer.span("bench.enqueue_request"):
            logits = port.forward(params, tokens)
        with tracer.span("bench.sync"):
            _sync(device)
        return tokens, logits

    first = [plan.length(i) for i in range(len(plan.cycle))]
    for n, length in enumerate(plan.shapes()):
        tokens, logits = request(first.index(length))
        checks.answer(logits, tokens)
        del tokens, logits
        if n == 0:
            laps.mark("first_step")
    laps.mark("warmup")
    answers, latencies, units = {}, [], []
    failed, done = 0, 0
    with tracer:
        start = laps.mark("profiler")
        with tracer.span(WINDOW):
            i = 0
            while True:
                begun = time.perf_counter()
                try:
                    tokens, logits = request(i)
                except RuntimeError:
                    failed += 1
                    latencies.append(math.inf)
                else:
                    latencies.append(time.perf_counter() - begun)
                    done += b * plan.length(i)
                    units.append((b, plan.length(i),
                                  port.attention(b, plan.length(i))))
                    if i in plan.sample:
                        with tracer.span("bench.keep_answer"):
                            answers[i] = checks.answer(logits, tokens)
                    del tokens, logits
                i += 1
                if time.perf_counter() - start >= seconds:
                    break
        end = time.perf_counter()
    for j in plan.sample:           # due in the window but not yet served
        if j not in answers:
            tokens, logits = request(j)
            answers[j] = checks.answer(logits, tokens)
            del tokens, logits
    window = dict(
        start=start, window_s=end - start, peak=_peak(device),
        attempted=len(latencies), failed=failed, units=units,
        rates={"tokens_per_s": done / (end - start),
               "p95_ms": float(np.percentile(latencies, 95)) * 1e3})
    del params
    _free(device)
    began = time.perf_counter()
    ref_params = {n: make_leaf(definition, model, n, seed, device)
                  for n in definition.leaf_shapes(model)}
    numbers: Dict[str, float] = {}
    for j in plan.sample:
        tokens = plan.prompt(j).to(device)
        ref_logits = definition.logits(ref_params, tokens, model, "f32")
        for name, value in checks.score_numbers(*answers[j], ref_logits,
                                                tokens).items():
            numbers[name] = max(numbers.get(name, -math.inf), value)
        del ref_logits
    window["numbers"] = numbers
    window["reference_s"] = time.perf_counter() - began
    return window


def _peak(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def _outcome(cell, trace: bool, device, tracer, window) -> Outcome:
    numbers = window["numbers"]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": name, "count": cell.chips,
           "memory_peak_bytes": window["peak"]}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics, breakdown = {}, None
    seconds = {f"setup.{part}": v
               for part, v in window["setup_parts"].items()}
    seconds["reference_s"] = window["reference_s"]
    if trace:
        began = time.perf_counter()
        events = tracer.events()
        view = View(cell.mix["kind"], cell.model, cell.definition,
                    window["units"], events, lookup(name))
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        for metric in cell.per_layer:
            value = cell.readers[metric["name"]](view)
            if value is not None:
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
        breakdown = {"device_ops": events.top_ops(),
                     "idle_gaps": events.idle_gaps()}
        seconds["trace_read_s"] = time.perf_counter() - began
    else:
        names = cell.mix["report"]
        values = {"setup_s": window["setup_s"],
                  **{names[q]: v for q, v in window["rates"].items()
                     if q in names}}
        for metric in cell.end_to_end:
            if metric["name"] in values:
                metrics[metric["name"]] = {"value": values[metric["name"]],
                                           "unit": metric["unit"]}
    correct = (checks.judge(numbers, cell.limits) and window["failed"] == 0)
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {
        k: {"value": v, "limit": cell.limits.get(k, {}).get("limit")}
        for k, v in numbers.items()}
    return Outcome(result, numbers, seconds, window.get("detail", {}))
