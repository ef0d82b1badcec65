#!/usr/bin/env python3
"""Where a traced window's device time goes, by the port's own spans.

    python3 benchmarks/split.py --workload <name> --seed <n> --seconds <s>
                                [--record 0|1]

From the root of a checkout, on the card. Runs one cell as `run.py
--trace 1` does (harness/cell.py's set-up, window and check, the card
traced by CUPTI alone), with the port's recording
(`tpu_device_plugin_torch.validator.tracing.recording()`) open around the
window when `--record 1` (the default), and joins the trace to the port's
spans by launch (harness/attribution.py). `--record 0` runs the same
traced window without the port's recording: the two side by side give
what recording costs. The last line of standard output is one JSON
object:

- `correct`, `attempted`, `metrics` (the cell's per-layer metrics, read
  from the same window), `breakdown` (`idle_gaps` by the innermost span,
  the benchmark's or the port's), as in run.py's traced line;
- `rates`: the traced window's rates (`tokens_per_s`, scoring `p95_ms`);
  `host_ms`: the host's time a step or request in its `bench.enqueue_*`
  span, mean;
- with `--record 1`: `split`, ms a step or request by port module (the
  spans of `attribution.MODULES`, forward and `.bwd`; `root`, a root span
  alone; `outside`; `unmatched`) for the `other` kernel group and for all
  device work; `top_other`, each module's largest `other` kernels;
  `nongemm_ms`, the `other` group's time a unit over all buckets;
  `joins`, the checks of the join (attribution.Placed); and `counts`,
  the port's counters over the window (`moe.routed`, `moe.dropped`)
  with `moe_dropped_pct`.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _tracer_class():
    from harness.trace import WINDOW, Tracer, read_events

    class PortTracer(Tracer):
        """The harness's tracer, with the port's recording open around the
        window (`record`) and the profiler's raw events kept; its Events
        hold the port's spans beside the benchmark's."""

        def __init__(self, enabled, device, record: bool):
            super().__init__(enabled, device)
            self.record = record
            self.raw, self.recorder = [], None

        def span(self, name):
            if name == WINDOW and self.record:
                return self._recorded(super().span(name))
            return super().span(name)

        @contextlib.contextmanager
        def _recorded(self, window):
            from tpu_device_plugin_torch.validator import tracing
            with tracing.recording() as rec, window:
                yield
            self.recorder = rec

        def port_spans(self):
            return self.recorder.spans if self.recorder else []

        def events(self):
            if self._prof is not None:
                self.raw = list(self._prof.profiler.kineto_results.events())
            events = read_events(self.raw, self.spans)
            events.spans += [(s.name, s.start_ns, s.end_ns)
                             for s in self.port_spans()]
            return events

    return PortTracer


def split(cell, seed: int, seconds: float, record: bool, device,
          t0: float) -> dict:
    import torch
    from harness import attribution
    from harness import cell as cell_run
    from harness.program import Port

    device = torch.device(device)
    laps = cell_run.Laps(t0, device)
    port = Port(cell.definition, cell.model, device)
    tracer = _tracer_class()(True, device, record)
    if cell.mix["kind"] == "train":
        window = cell_run._train(cell, seed, seconds, device, laps, port,
                                 tracer, None)
    else:
        window = cell_run._score(cell, seed, seconds, device, laps, port,
                                 tracer)
    window["setup_s"] = window["start"] - t0
    window["setup_parts"] = laps.parts
    outcome = cell_run._outcome(cell, True, device, tracer, window)
    units = len(window["units"])
    enqueue = [e - s for name, s, e in tracer.spans
               if name.startswith("bench.enqueue_")]
    out = {k: outcome.result[k] for k in ("correct", "attempted", "metrics")}
    out["breakdown"] = outcome.result.get("breakdown")
    out["rates"] = window["rates"]
    out["host_ms"] = sum(enqueue) / len(enqueue) / 1e6 if enqueue else None
    if record and units:
        spans = tracer.port_spans()
        launches = attribution.read_launches(
            tracer.raw, next((s, e) for name, s, e in tracer.spans
                             if name == "bench.window"))
        placed = attribution.place(launches, spans)
        other = attribution.module_ms(placed, units, "other")
        out["split"] = {"other": other,
                        "all": attribution.module_ms(placed, units)}
        out["top_other"] = attribution.top_kernels(placed, units)
        out["nongemm_ms"] = sum(other.values())
        out["joins"] = {"matched_share": placed.matched_share,
                        "in_root_share": placed.in_root_share,
                        "bwd_share": placed.bwd_share,
                        "spans": len(spans), "units": units}
        counts = dict(tracer.recorder.counts)
        if counts.get("moe.routed"):
            counts["moe_dropped_pct"] = (100.0 * counts["moe.dropped"]
                                         / counts["moe.routed"])
        out["counts"] = counts
    out["checks"] = outcome.result["checks"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(CHECKOUT)]
    import torch
    from harness.spec import load_cell

    cell = load_cell(args.workload, CHECKOUT)
    if not torch.cuda.is_available():
        print("split.py: needs a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(split(cell, args.seed, args.seconds, bool(args.record),
                           "cuda", T0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
