"""What a per-layer metric's reader is given: the traced window of one run.

A reader (`benchmarks/metrics/<name>.py`) defines `read(view)` and returns
a number, or None where it finds nothing to read (another kind of cell, a
card without a peak in peaks.py, no kernel of its kind in the window).
The quantities the readers here take are below; a reader names one and
the kind of cell it reads in.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType
from typing import List, Optional, Tuple

from .counts import bound_s
from .peaks import Peak
from .trace import FLASH, Events


@dataclass
class View:
    kind: str                             # "train" or "score"
    model: dict                           # the configuration's model block
    definition: ModuleType                # its definition (block.py): the
    #                                       counts below are its own
    units: List[Tuple[int, int, str]]     # (batch, seq, attention mode) of
    #                                       each step or request in the window
    events: Events
    peak: Optional[Peak]

    @property
    def window_s(self) -> float:
        return self.events.window_ns / 1e9

    @property
    def busy_s(self) -> float:
        return self.events.busy_ns() / 1e9

    def seconds(self, *groups: str) -> float:
        """Device time of the kernels in `groups` (trace.group's names)."""
        by_group = self.events.time_by_group()
        return sum(by_group.get(g, 0) for g in groups) / 1e9


def mfu(view: View, kind: str) -> Optional[float]:
    """The model FLOPs of every step or request of the window (the
    definition's `model_flops`; the port's block's, counts.py: matmuls
    only, causal attention once) over the window's time, as a share (%) of
    the card's bf16 peak."""
    if view.kind != kind or not view.units or view.peak is None:
        return None
    flops = sum(view.definition.model_flops(view.model, b, s,
                                            train=kind == "train")
                for b, s, _ in view.units)
    return 100.0 * flops / view.window_s / view.peak.bf16_flops


def gemm_roofline(view: View, kind: str) -> Optional[float]:
    """The least time of every matmul that cuBLAS runs in the window, at
    the shapes it runs them (the definition's `gemm_work`), over the
    device time of the matmul kernels (trace.py's `gemm` group), as a
    share (%)."""
    if view.kind != kind or not view.units or view.peak is None:
        return None
    spent = view.seconds("gemm")
    if spent <= 0:
        return None
    bound = sum(bound_s(view.definition.gemm_work(view.model, b, s, mode,
                                                  train=kind == "train"),
                        view.peak)
                for b, s, mode in view.units)
    return 100.0 * bound / spent


def flash_roofline(view: View, kind: str) -> Optional[float]:
    """The least time of the attention work that the flash kernels run in
    the window (the definition's `attention_work`; the port's block's:
    causal FLOPs, inputs read and outputs written once; forward, and
    backward in training), over the device time of K1 to K3, as a share
    (%). Steps or requests that take einsum attention are not counted."""
    if view.kind != kind or view.peak is None:
        return None
    spent = view.seconds(*FLASH)
    flash = [(b, s) for b, s, mode in view.units if mode == "flash"]
    if spent <= 0 or not flash:
        return None
    bound = sum(bound_s(view.definition.attention_work(
        view.model, b, s, train=kind == "train"), view.peak)
        for b, s in flash)
    return 100.0 * bound / spent


def device_idle(view: View, kind: str) -> Optional[float]:
    """The share (%) of the window in which no kernel, memcpy or memset ran
    on the card."""
    if view.kind != kind or view.window_s <= 0 or not view.events.device:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def nongemm_ms(view: View) -> Optional[float]:
    """Device time per training step of the kernels that are neither
    matmuls nor K1-K3 (norms, GELU, casts, copies, the MoE dispatch, the
    loss, the SGD update), in ms."""
    if view.kind != "train" or not view.units or not view.events.device:
        return None
    return 1e3 * view.seconds("other") / len(view.units)
