"""The port's block as a definition: what a configuration without a
`definition` key gets.

A definition is everything the harness knows of a configuration's block,
as module-level names; a configuration's file names its own with
`"definition": "benchmarks/definitions/<name>.py"` (a path in the
checkout, loaded as spec.load_definition says), beside its `model` block.
`model` below is that block.

- Leaves: `leaf_shapes(model) -> {dotted name: shape}` in the port's
  layout, and optionally `leaf_scale(model, name)`, the factor on a leaf's
  N(0, 1) draw (this module's where a definition has none).
- Reference: `sgd_step(params, momentum, tokens, model, precision, routes)`
  and `logits(params, tokens, model, precision)`, plain PyTorch on flat
  {name: leaf} dicts, in float32 with TF32 off at `precision="f32"` and a
  step lower at `"fp8"` (program.Control); importing nothing of the port
  and no JAX.
- Routes: `new_routes(model, by_layer=None, follow=False)`, None for a
  block that routes nothing, else an object with `by_layer` ({layer:
  tensor}, what the port took) and `gap` (how far the reference would
  have routed otherwise, `route_gap`), which the reference records where
  `follow` is False and follows where it is True; `record(workload,
  routes)`, a context manager that records into `routes` the routes the
  port's `workload` module takes while it is open (the followed steps).
- Counts: `model_flops`, `gemm_work` and `attention_work`, with
  counts.py's signatures, which metrics.py's readers take.

The port's block: RMSNorm without gain, full causal multi-head attention
over d x d projections, and a tanh-GELU MLP or a top-1 switch MoE
(reference.py, counts.py).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

from .counts import attention_work, gemm_work, model_flops  # noqa: F401
from .reference import Routes, logits, sgd_step  # noqa: F401


def leaf_shapes(model: dict) -> Dict[str, Tuple[int, ...]]:
    """`embed`, `unembed`, `layers.{wq,wk,wv,wo}` and `layers.{w1,w2}` or,
    for MoE, `layers.{wr,w1e,w2e}`, stacked on the layer dim."""
    v, d, ff = model["vocab"], model["d_model"], model["d_ff"]
    n, e = model["n_layers"], model.get("n_experts", 0)
    shapes = {"embed": (v, d), "unembed": (d, v),
              "layers.wq": (n, d, d), "layers.wk": (n, d, d),
              "layers.wv": (n, d, d), "layers.wo": (n, d, d)}
    if e:
        shapes.update({"layers.wr": (n, d, e), "layers.w1e": (n, e, d, ff),
                       "layers.w2e": (n, e, ff, d)})
    else:
        shapes.update({"layers.w1": (n, d, ff), "layers.w2": (n, ff, d)})
    return shapes


def leaf_scale(model: dict, name: str) -> float:
    return model["d_model"] ** -0.5


def new_routes(model: dict, by_layer=None,
               follow: bool = False) -> Optional[Routes]:
    if not model.get("n_experts"):
        return None
    return Routes(by_layer, follow)


@contextlib.contextmanager
def record(workload, routes: Optional[Routes]):
    """Records the MoE's top-1 route of each layer into `routes` by
    wrapping the port's `workload._route` for the duration."""
    if routes is None:
        yield
        return
    original, taken = workload._route, []

    def recording(xt, wr):
        gate, top1 = original(xt, wr)
        taken.append(top1)
        return gate, top1

    workload._route = recording
    try:
        yield
    finally:
        workload._route = original
    routes.by_layer.update(enumerate(taken))
