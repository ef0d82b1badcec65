"""The system under test, and what may stand in its place.

`Port` is the only code of the benchmark that calls into
`tpu_device_plugin_torch`: the training step `workload.sgd_step` (the
step that `build_workload` returns) and the serving forward
`workload.forward`, with the attention mode that the port's own rule
(`workload._resolve`: flash from `FLASH_MIN_SEQ` on, on CUDA) picks for
each (batch, seq). While a training step records routes, the
configuration's definition (block.py) records the port's into them.

The others stand in its place for the checks of the check: `Control`,
the definition's reference computed a precision below the port's; and
the faults a cell can have, each planted in the port's timed path:
`Unchanged` (a step that leaves the state as it was), `HalfBatch` (half
of the batch left out, the mean taken over the rest; a scoring request's
left-out prompts answered with the others' logits) and `AlteredAnswer`
(one prompt's logits, the first of each request, altered where they are
produced).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .inputs import flatten


class Port:
    def __init__(self, definition, model: dict, device):
        from tpu_device_plugin_torch.validator import workload
        self._w = workload
        self._definition = definition
        self._model = model
        self._device = torch.device(device)
        self._cfgs: Dict[Tuple[int, int], tuple] = {}

    def _cfg(self, batch: int, seq: int):
        key = (batch, seq)
        if key not in self._cfgs:
            cfg = self._w.ModelConfig(**self._model, batch=batch, seq_len=seq)
            _, _, mode = self._w._resolve(cfg, None, None, self._device)
            self._cfgs[key] = (cfg, mode)
        return self._cfgs[key]

    def attention(self, batch: int, seq: int) -> str:
        return self._cfg(batch, seq)[1]

    def step(self, params: dict, momentum: dict, tokens: torch.Tensor,
             routes=None) -> torch.Tensor:
        """One training step, params and momentum updated in place; the
        loss before the update. `routes` (the followed steps only: the
        window never records) records the port's routes."""
        cfg, mode = self._cfg(*tokens.shape)
        with self._definition.record(self._w, routes):
            return self._w.sgd_step(params, momentum, tokens, cfg, mode)[2]

    def forward(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        cfg, mode = self._cfg(*tokens.shape)
        with torch.no_grad():
            return self._w.forward(params, tokens, cfg, mode)


class Control(Port):
    """The definition's reference in the port's place, at `precision`
    ("fp8")."""

    def __init__(self, definition, model: dict, device,
                 precision: str = "fp8"):
        super().__init__(definition, model, device)
        self.precision = precision

    def step(self, params, momentum, tokens, routes=None):
        return self._definition.sgd_step(flatten(params), flatten(momentum),
                                         tokens, self._model, self.precision,
                                         routes)

    def forward(self, params, tokens):
        return self._definition.logits(flatten(params), tokens, self._model,
                                       self.precision)


class Unchanged(Port):
    def step(self, params, momentum, tokens, routes=None):
        cfg, mode = self._cfg(*tokens.shape)
        with torch.no_grad(), self._definition.record(self._w, routes):
            return self._w.loss_fn(params, tokens, cfg, mode)


class HalfBatch(Port):
    def step(self, params, momentum, tokens, routes=None):
        return super().step(params, momentum, tokens[:len(tokens) // 2],
                            routes)

    def forward(self, params, tokens):
        half = super().forward(params, tokens[:len(tokens) // 2])
        return torch.cat([half, half])[:len(tokens)]


class AlteredAnswer(Port):
    def forward(self, params, tokens):
        logits = super().forward(params, tokens)
        logits[0] = logits[0].roll(1, -1)
        return logits


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch,
          "altered_answer": AlteredAnswer}
# the faults each kind of cell can have: a training step produces a loss
# and a state, not tokens; a scoring request has no state to leave
FAULTS_OF = {"train": ("unchanged", "half_batch"),
             "score": ("half_batch", "altered_answer")}
