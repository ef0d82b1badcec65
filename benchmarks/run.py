#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s>
                              --trace <0|1>

From the root of a checkout. The cell is found by name (harness/spec.py);
the program under test is `tpu_device_plugin_torch`. The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each checked number beside its limit; the same numbers
are the last lines of standard error.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, and when JAX, jaxlib, flax or the JAX package
`tpu_device_plugin` is loaded at start-up or once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout: only a cell's
    first run there builds. The port's own kernels build into
    `tpu_device_plugin_torch/validator/_build/`, also in the checkout."""
    cache = CHECKOUT / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    sys.path[:0] = [str(HERE), str(CHECKOUT)]
    import torch
    from harness import cell as cell_run
    from harness.guard import forbidden_loaded
    from harness.spec import load_cell

    found = forbidden_loaded()
    if found:
        print("run.py: loaded at start-up: " + ", ".join(found),
              file=sys.stderr)
        return 3
    cell = load_cell(args.workload, CHECKOUT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"CUDA available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    outcome = cell_run.run(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    found = forbidden_loaded()
    if found:
        print("run.py: loaded beside the port: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for name, value in outcome.seconds.items():
        print(f"{name} {value:.3f}", file=sys.stderr)
    for name, check in outcome.result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    print(json.dumps(outcome.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
