#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 benchmarks/readings.py --workload <name> --seeds 1,2,...
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--seconds 1]

For each seed, one run of the cell as `run.py` makes it, with a short
window at the cell's own load (`--seconds`; the sampled requests are
served in full whatever it is): the numbers that decide `correct`, the
lower readings. On the control seeds, the same run with the control in
the port's place (the reference in fp8, program.Control), and on the
fault seeds with each fault the cell can have planted in the port's timed
path (program.FAULTS_OF): the upper readings. One JSON line per run; the
f32 reference of a training cell is computed once per seed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--fault-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch
    from harness import cell as cell_run
    from harness import program
    from harness.spec import load_cell

    cell = load_cell(args.workload, HERE.parent)
    kind = cell.mix["kind"]
    if not torch.cuda.is_available():
        print("readings.py: CUDA is not available", file=sys.stderr)
        return 2
    runs = [("program", program.Port, s) for s in args.seeds]
    runs += [("control", program.Control, s) for s in args.control_seeds]
    runs += [(f, program.FAULTS[f], s) for f in program.FAULTS_OF[kind]
             for s in args.fault_seeds]
    ref_cache: dict = {}
    for who, make, seed in runs:
        began = time.perf_counter()
        port = make(cell.definition, cell.model, "cuda")
        outcome = cell_run.run(cell, seed, args.seconds, False, "cuda",
                               began, port=port, ref_cache=ref_cache)
        print(json.dumps({
            "workload": cell.name, "who": who, "seed": seed,
            "numbers": outcome.numbers, "worst_leaves": outcome.detail,
            "metrics": {k: v["value"]
                        for k, v in outcome.result["metrics"].items()},
            "memory_peak_bytes":
                outcome.result["device"]["memory_peak_bytes"],
            "run_s": time.perf_counter() - began}), flush=True)
    print(f"readings.py: {len(runs)} runs in {time.perf_counter() - T0:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
