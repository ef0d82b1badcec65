"""The one launch path of the hand-written CUDA kernels (`_kernels.launch`)
on the CPU, with no card and no library.

- Each entry of `_kernels.ENTRIES` against its `extern "C"` declaration in
  `validator/csrc/*.cu`, type for type: ctypes passes an argument past
  `argtypes` as a C int, and converts one to a mistyped parameter, without
  a word, so a wrong entry would show only as a wrong stride or stream on
  the card.
- `launch` against a stub library: it types a symbol once, passes the
  device's current stream last under the device's guard, counts each
  named launch under one lock, and raises on a non-zero return;
  `on_card` sends a CPU tensor to the plain versions.
- Each kernel wrapper's launch site passes its entry's parameters, each
  one convertible to its type.
"""

import ctypes
import re
import sys
import threading
import time
import types

import pytest
import torch

from tpu_device_plugin_torch.validator import _kernels, short_conv, ssd, xent
from tpu_device_plugin_torch.validator import flash_attention as fa

STREAM = 0x5EED
_DECLARATION = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')


def _ctype(param: str) -> type:
    """The ctypes type of one C parameter, its name dropped."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split()[:-1] if w != "const"]
    return {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong,
            ("float",): ctypes.c_float}[tuple(words)]


def _declarations():
    """{entry: (library, return type, parameter types)} of every
    `extern "C"` function in csrc/*.cu."""
    found = {}
    for src in sorted(_kernels.CSRC.glob("*.cu")):
        for ret, name, params in _DECLARATION.findall(src.read_text()):
            assert name not in found, f"{name} declared twice"
            found[name] = (src.stem, ret,
                           tuple(_ctype(p) for p in params.split(",")))
    return found


@pytest.mark.parametrize("entry", sorted(_kernels.ENTRIES))
def test_entry_matches_its_c_declaration(entry):
    library, ret, params = _declarations()[entry]
    assert ret == "int"
    assert _kernels.ENTRIES[entry] == (library, params)
    assert params[-1] is ctypes.c_void_p   # the stream


def test_every_declaration_has_an_entry_and_every_entry_a_declaration():
    assert set(_declarations()) == set(_kernels.ENTRIES)


def test_on_card_is_false_on_the_cpu_and_refuses_other_devices():
    assert _kernels.on_card(torch.zeros(2), "thing") is False
    with pytest.raises(ValueError, match="^thing runs on cpu or cuda, not meta"):
        _kernels.on_card(torch.empty(2, device="meta"), "thing")


class _Symbol:
    def __init__(self, ret: int):
        self.ret, self.calls = ret, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


class _Library:
    def __init__(self, ret: int):
        self.ret, self.symbols = ret, {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.symbols.setdefault(name, _Symbol(self.ret))


def _all_counts():
    """Every kernel wrapper's launch counts."""
    return (fa.launches, xent.launches, short_conv.launches,
            short_conv.ungated_launches, ssd.launches)


@pytest.fixture
def stub(monkeypatch):
    """`_kernels.library` returns a `_Library` of Python callables (the
    return code in `stub.ret`); the device guard and the current stream
    are stand-ins; the kernel modules' counts are put back after."""
    opened, guarded, libs = [], [], {}

    def library(name):
        opened.append(name)
        return libs.setdefault(name, _Library(state.ret))

    class _Guard:
        def __init__(self, device):
            guarded.append(device)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    state = types.SimpleNamespace(ret=0, opened=opened, guarded=guarded,
                                  libs=libs)
    monkeypatch.setattr(_kernels, "library", library)
    monkeypatch.setattr(_kernels, "_fns", {})
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=STREAM))
    saved = [(counts, dict(counts)) for counts in _all_counts()]
    yield state
    for counts, before in saved:
        counts.update(before)


def test_launch_types_a_symbol_once_and_passes_the_stream_last(stub):
    counts = {"conv_fwd": 0}
    for _ in range(2):
        _kernels.launch("conv_fwd", "dev", 1, 2, 3, 4, 5, 6, 7, 8,
                        launches=counts)
    fn = stub.libs["short_conv"].symbols["conv_fwd"]
    assert stub.opened == ["short_conv"]
    assert fn.argtypes == list(_kernels.ENTRIES["conv_fwd"][1])
    assert fn.restype is ctypes.c_int
    assert fn.calls == [(1, 2, 3, 4, 5, 6, 7, 8, STREAM)] * 2
    assert stub.guarded == ["dev", "dev"]
    assert counts == {"conv_fwd": 2}


def test_launch_adds_one_to_each_counted_name(stub):
    counts = {"flash_bwd_dkv": 0, "flash_bwd_dq": 0}
    args = [0] * (len(_kernels.ENTRIES["flash_bwd"][1]) - 1)
    _kernels.launch("flash_bwd", "dev", *args, launches=counts,
                    count=["flash_bwd_dkv", "flash_bwd_dq"])
    _kernels.launch("flash_bwd", "dev", *args, launches=counts,
                    count=["flash_bwd_dq"])
    _kernels.launch("flash_bwd", "dev", *args, launches=counts, count=[])
    assert counts == {"flash_bwd_dkv": 1, "flash_bwd_dq": 2}


def test_launch_raises_naming_the_entry_and_the_error(stub):
    stub.ret = 700
    counts = {"xent_bwd": 0}
    with pytest.raises(RuntimeError,
                       match="^xent_bwd kernel launch failed: CUDA error 700$"):
        _kernels.launch("xent_bwd", "dev", *range(12), launches=counts)
    assert counts == {"xent_bwd": 0}


class _YieldingCounts(dict):
    """A dict whose reads hand the interpreter to another thread, so an
    unlocked read-modify-write of a count loses updates."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_lose_no_update_across_threads(stub):
    counts = _YieldingCounts(conv_fwd=0)
    n_threads, per_thread = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _kernels.launch("conv_fwd", "dev", *range(8), launches=counts)
            for _ in range(per_thread)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counts == {"conv_fwd": n_threads * per_thread}


def _flash_fwd(monkeypatch):
    monkeypatch.setattr(fa, "on_card", lambda t, what: True)
    q = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    fa.flash_attention_fwd(q, q, q, 0.25, True, return_lse=True)
    return fa.launches, {"flash_fwd": 1}


def _flash_bwd(monkeypatch):
    q = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    stats = torch.zeros(2, 8)
    fa.launch_bwd(q, q, q, q, stats, stats, None, torch.zeros_like(q),
                  torch.zeros_like(q), 0.25, True)
    return fa.launches, {"flash_bwd_dkv": 1}


def _xent_fwd(monkeypatch):
    logits = torch.zeros(2, 5, 11, dtype=torch.bfloat16)
    xent.nll_rows(logits, torch.zeros(2, 4, dtype=torch.long))
    return xent.launches, {"xent_fwd": 1}


def _xent_bwd(monkeypatch):
    logits = torch.zeros(2, 5, 11, dtype=torch.bfloat16)
    xent.nll_grad(logits, torch.zeros(2, 4, dtype=torch.long),
                  torch.zeros(2, 4), torch.ones(()))
    return xent.launches, {"xent_bwd": 1}


def _conv_fwd(monkeypatch):
    short_conv.conv_fwd(torch.zeros(2, 9, 48, dtype=torch.bfloat16),
                        torch.zeros(3, 16))
    return short_conv.launches, {"conv_fwd": 1}


def _conv_bwd(monkeypatch):
    short_conv.conv_bwd(torch.zeros(2, 9, 48, dtype=torch.bfloat16),
                        torch.zeros(3, 16),
                        torch.zeros(2, 9, 16, dtype=torch.bfloat16))
    return short_conv.launches, {"conv_bwd": 1}


def _conv_silu_fwd(monkeypatch):
    # a slice of a wider projection's rows, as the Mamba mixer passes it
    x = torch.zeros(2, 9, 40, dtype=torch.bfloat16)[..., 8:32]
    short_conv.conv_silu_fwd(x, torch.zeros(4, 24), torch.zeros(24))
    return short_conv.ungated_launches, {"conv_silu_fwd": 1}


def _conv_silu_bwd(monkeypatch):
    x = torch.zeros(2, 9, 40, dtype=torch.bfloat16)[..., 8:32]
    short_conv.conv_silu_bwd(x, torch.zeros(4, 24), torch.zeros(24),
                             torch.zeros(2, 9, 24, dtype=torch.bfloat16))
    return short_conv.ungated_launches, {"conv_silu_bwd": 1}


def _scan_inputs():
    """x, dt, a, B, C, D as the Mamba mixer passes them: x, B and C views
    of one (b, s, heads x 64 + 2 x 128) row."""
    xbc = torch.zeros(1, 5, 2 * 64 + 2 * 128, dtype=torch.bfloat16)
    x, B, C = xbc.split([128, 128, 128], -1)
    return (x.view(1, 5, 2, 64), torch.zeros(1, 5, 2), torch.zeros(2),
            B.view(1, 5, 1, 128), C.view(1, 5, 1, 128), torch.zeros(2))


def _ssd_fwd(monkeypatch):
    ssd.ssd_fwd(*_scan_inputs(), True)
    return ssd.launches, {"ssd_fwd": 1}


def _ssd_bwd(monkeypatch):
    inputs = _scan_inputs()
    ssd.ssd_bwd(*inputs, torch.zeros(1, 1, 2, 64, 128),
                torch.zeros(1, 5, 2, 64, dtype=torch.bfloat16))
    return ssd.launches, {"ssd_bwd": 1}


@pytest.mark.parametrize("entry, call", [
    ("flash_fwd", _flash_fwd), ("flash_bwd", _flash_bwd),
    ("xent_fwd", _xent_fwd), ("xent_bwd", _xent_bwd),
    ("conv_fwd", _conv_fwd), ("conv_bwd", _conv_bwd),
    ("conv_silu_fwd", _conv_silu_fwd), ("conv_silu_bwd", _conv_silu_bwd),
    ("ssd_fwd", _ssd_fwd), ("ssd_bwd", _ssd_bwd),
])
def test_each_launch_site_passes_its_entrys_parameters(stub, monkeypatch,
                                                       entry, call):
    library, argtypes = _kernels.ENTRIES[entry]
    before = [(c, dict(c)) for c in _all_counts()]
    counts, moved = call(monkeypatch)
    args, = stub.libs[library].symbols[entry].calls
    assert len(args) == len(argtypes) and args[-1] == STREAM
    for arg, argtype in zip(args, argtypes):
        argtype.from_param(arg)   # raises where ctypes could not convert
    for c, was in before:
        assert c == {k: n + (moved.get(k, 0) if c is counts else 0)
                     for k, n in was.items()}
