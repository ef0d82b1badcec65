"""Spans and counters inside the port, recorded only while a caller asks.

    with tracing.recording() as rec:
        workload.sgd_step(...)
    rec.spans, rec.counts

`recording()` opens the one recorder of the process; without it `span`
returns a shared no-op context manager and `count` and `backward` return
at once: one global check, no allocation, no clock read, no tensor op, no
autograd hook.

A span is `Span(name, start_ns, end_ns, thread, parent, unit)`: times from
`time.time_ns()`, the clock of the torch profiler's timestamps;
`thread` is `threading.get_ident()` of the thread that opened it (the
POSIX thread id, whose low 32 bits CUPTI gives each launch record);
`parent` the index in `rec.spans` of the span open around it on the same
thread (None at the top); `unit` the index of the step or request, counted
by the root spans (`span(name, root=True)`), which every span opened
while that unit is current shares, on any thread.

`backward(name, x, y)` brackets the backward of the module that took `x`
to `y` in a span `name + ".bwd"` on the thread that runs the backward
(the autograd engine's, on a CUDA device): it opens when `y`'s gradient
arrives (a pre-hook of `y.grad_fn`) and closes when `x`'s is complete (a
hook on `x`). Autograd runs a node's tensor hooks before its pre-hooks,
so where one module's input is the next one's output the first bracket
closes before the next opens. Inside a backward (the recomputation of a
checkpointed layer) no bracket is added: the recomputed graph is never
run backward, and the hook on `x`, the layer's real input, would close
the bracket twice.

`count(name, value)` adds a Python int or a 0-d device tensor to a named
counter, outside a backward (`counting()`); device values are kept on the
device and summed and read once, when the recording closes, so nothing
waits for the card in between.
Nothing is written to disk: the caller reads `rec.spans` and `rec.counts`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    unit: int


class Recorder:
    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self._pending: Dict[str, List[torch.Tensor]] = {}
        self._open = threading.local()
        self._unit = -1
        self._lock = threading.Lock()

    def _stack(self) -> List[int]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def begin(self, name: str, root: bool = False) -> int:
        """Opens a span on this thread; returns its index in `spans`."""
        stack = self._stack()
        with self._lock:
            if root:
                self._unit += 1
            index = len(self.spans)
            self.spans.append(Span(name, time.time_ns(), 0,
                                   threading.get_ident(),
                                   stack[-1] if stack else None, self._unit))
        stack.append(index)
        return index

    def end(self, index: int) -> None:
        """Closes the span `index`, the innermost one open on this thread."""
        stack = self._stack()
        if stack and stack[-1] == index:
            stack.pop()
        self.spans[index] = self.spans[index]._replace(end_ns=time.time_ns())

    @contextlib.contextmanager
    def span(self, name: str, root: bool) -> Iterator[None]:
        index = self.begin(name, root)
        try:
            yield
        finally:
            self.end(index)

    def count(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            self._pending.setdefault(name, []).append(value.detach())
        else:
            self.counts[name] = self.counts.get(name, 0) + int(value)

    def close(self) -> None:
        for name, values in self._pending.items():
            total = int(torch.stack(values).sum().item())
            self.counts[name] = self.counts.get(name, 0) + total
        self._pending.clear()


_active: Optional[Recorder] = None
_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """The recorder, active until the block ends; one at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    rec = _active = Recorder()
    try:
        yield rec
    finally:
        _active = None
        rec.close()


def counting() -> bool:
    """Whether counters are taken now: a recording is open, and this is not
    the recomputation of a checkpointed layer inside a backward (which
    would count its forward twice). A caller that must compute a
    counter's value tests this first."""
    return _active is not None and torch._C._current_graph_task_id() == -1


def span(name: str, root: bool = False):
    """A context manager: the span `name` while recording, else a no-op."""
    if _active is None:
        return _NO_SPAN
    return _active.span(name, root)


def count(name: str, value) -> None:
    if counting():
        _active.count(name, value)


def backward(name: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Returns `y`, the output of the module that took `x`; while recording
    a graph, brackets that module's backward in `name + ".bwd"`."""
    rec = _active
    if (rec is None or y.grad_fn is None or not x.requires_grad
            or torch._C._current_graph_task_id() != -1):
        return y
    name += ".bwd"
    opened: List[int] = []

    def begin(grad_outputs):
        opened.append(rec.begin(name))

    def end(grad):
        if opened:
            rec.end(opened.pop())

    y.grad_fn.register_prehook(begin)
    x.register_hook(end)
    return y
