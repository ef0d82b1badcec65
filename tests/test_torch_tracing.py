"""The port's recorder (validator/tracing.py) around `workload.py`, on the CPU.

Without a recorder the instrumented step is the step: the same aten ops in
the same order as with `span`, `count` and `backward` replaced by bare
no-ops, no tensor hook, and bit for bit the loss and parameters of a step
run under `recording()`. With one, the spans nest as designed, forward and
backward, with and without recomputation (`remat`), and the MoE's drop
counter equals the drops of `_moe_onehot`'s one-hot queue on the same
router inputs. On the CPU the autograd engine runs the backward on the
calling thread, so there the `.bwd` spans share the step's thread.
"""

import contextlib
import threading

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_device_plugin_torch.validator import tracing
from tpu_device_plugin_torch.validator import workload as w

TINY = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=3,
            seq_len=16, batch=2)
MODELS = {"dense": dict(TINY), "moe": dict(TINY, n_experts=4)}


@pytest.fixture(autouse=True, scope="module")
def _small_torch_pool():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _build(model: str, **over):
    cfg = w.ModelConfig(**{**MODELS[model], **over})
    return (cfg,) + w.build_workload(cfg, seed=3, device="cpu")


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _bare(monkeypatch):
    monkeypatch.setattr(tracing, "span",
                        lambda name, root=False: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "count", lambda name, value: None)
    monkeypatch.setattr(tracing, "counting", lambda: False)
    monkeypatch.setattr(tracing, "backward", lambda name, x, y: y)


def _step_ops(model: str):
    _, step, params, momentum, tokens = _build(model)
    with _Ops() as mode:
        step(params, momentum, tokens)
    return mode.ops


@pytest.mark.parametrize("model", sorted(MODELS))
def test_without_a_recorder_the_step_runs_the_ops_of_bare_no_ops(
        model, monkeypatch):
    shipped = _step_ops(model)
    _bare(monkeypatch)
    assert shipped == _step_ops(model)
    assert len(shipped) > 50


@pytest.mark.parametrize("model", sorted(MODELS))
def test_without_a_recorder_no_hook_is_registered(model, monkeypatch):
    registered = []
    original = torch.Tensor.register_hook

    def spy(self, hook):
        registered.append(hook)
        return original(self, hook)

    monkeypatch.setattr(torch.Tensor, "register_hook", spy)
    _, step, params, momentum, tokens = _build(model)
    step(params, momentum, tokens)
    assert registered == []
    with tracing.recording():
        step(params, momentum, tokens)
    # a hook on each module's input: per layer two, and the head's
    assert len(registered) == 2 * TINY["n_layers"] + 1


@pytest.mark.parametrize("model", sorted(MODELS))
def test_a_recorded_step_is_bit_for_bit_the_unrecorded_one(model):
    _, step, params, momentum, tokens = _build(model)
    _, _, loss = step(params, momentum, tokens)
    _, step2, params2, momentum2, _ = _build(model)
    with tracing.recording() as rec:
        _, _, loss2 = step2(params2, momentum2, tokens)
    assert rec.spans
    assert torch.equal(loss, loss2)
    for a, b in zip(w._leaves(params) + w._leaves(momentum),
                    w._leaves(params2) + w._leaves(momentum2)):
        assert torch.equal(a, b)


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_spans_nest_forward_and_backward(model, remat):
    _, step, params, momentum, tokens = _build(model, remat=remat)
    steps, layers = 2, TINY["n_layers"]
    with tracing.recording() as rec:
        for _ in range(steps):
            step(params, momentum, tokens)
    spans = rec.spans
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["workload.sgd_step"] * steps
    me = threading.get_ident()
    for unit, root in enumerate(roots):
        top = spans[root]
        assert top.unit == unit and top.thread == me
        mine = [s for s in spans if s.unit == unit]
        assert all(top.start_ns <= s.start_ns and s.end_ns <= top.end_ns
                   for s in mine)
        # forward per layer, the head, the backward in reverse layer
        # order, the update
        bwd = ["workload.head.bwd"] + [
            f"workload.{m}.bwd" for _ in range(layers)
            for m in ("ffn", "attention")]
        assert _children(spans, root) == (
            ["workload.attention", "workload.ffn"] * layers
            + ["workload.head"] + bwd + ["workload.sgd_update"])
        brackets = [(i, s) for i, s in enumerate(spans)
                    if s.unit == unit and s.name.endswith(".bwd")]
        assert all(s.thread == me for _, s in brackets)
        for (_, a), (_, b) in zip(brackets, brackets[1:]):
            assert a.end_ns <= b.start_ns
        # recomputation runs each layer's forward again inside the
        # backward bracket of its second half, which closes last
        for i, s in brackets:
            inner = _children(spans, i)
            if remat and s.name == "workload.ffn.bwd":
                assert inner == ["workload.attention", "workload.ffn"]
            else:
                assert inner == []


def test_a_request_is_one_unit_without_backward_brackets():
    cfg, _, params, _, tokens = _build("moe")
    with tracing.recording() as rec, torch.no_grad():
        for _ in range(2):
            w.forward(params, tokens, cfg)
    names = [(s.name, s.unit) for s in rec.spans]
    one = (["workload.forward"]
           + ["workload.attention", "workload.ffn"] * TINY["n_layers"]
           + ["workload.head"])
    assert names == [(n, 0) for n in one] + [(n, 1) for n in one]
    assert rec.counts["moe.routed"] == 2 * TINY["n_layers"] * tokens.numel()


def _onehot_drops(top1: torch.Tensor, cfg: w.ModelConfig) -> int:
    """Tokens past capacity by `_moe_onehot`'s queue: the one-hot running
    count over tokens, kept where within capacity."""
    t, e = top1.shape[0], cfg.n_experts
    cap = w._capacity(t, e, cfg.capacity_factor)
    onehot = F.one_hot(top1, e).float()
    pos = onehot.cumsum(0) * onehot
    within = (pos > 0) & (pos <= cap)
    return int(t - within.sum())


@pytest.mark.parametrize("remat", [False, True])
def test_moe_dropped_counts_the_one_hot_queues_drops(remat, monkeypatch):
    cfg, step, params, momentum, tokens = _build(
        "moe", capacity_factor=0.25, remat=remat)
    routes = []
    original = w._route

    def keep(xt, wr):
        gate, top1 = original(xt, wr)
        if torch._C._current_graph_task_id() == -1:
            routes.append(top1)
        return gate, top1

    monkeypatch.setattr(w, "_route", keep)
    with tracing.recording() as rec:
        step(params, momentum, tokens)
    assert len(routes) == TINY["n_layers"]
    dropped = sum(_onehot_drops(top1, cfg) for top1 in routes)
    assert dropped > 0
    assert rec.counts == {"moe.routed": TINY["n_layers"] * tokens.numel(),
                          "moe.dropped": dropped}


def test_one_recording_at_a_time_and_none_after():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    assert not tracing.counting()
    assert tracing.span("x") is tracing.span("y")
