"""The join of the card's trace to the port's spans (harness/attribution.py)
on synthetic raw profiler events, and split.py on the CPU's tiny cells.

The raw events mimic what the profiler gives with the card alone traced:
kernels and copies on the CUDA device, each with the correlation id of its
launch, and on the host the CUDA API calls with that id, the
host time of the call and the low 32 bits of the calling thread's POSIX
id, beside records of the profiler's own that may repeat an id."""

import json
import time
from collections import namedtuple

import pytest
import torch

from harness import attribution, block, metrics
from harness.peaks import lookup
from harness.spec import load_cell
from harness.trace import read_events

from tiny import BENCH, make

Span = namedtuple("Span", "name start_ns end_ns thread parent unit")
CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
# POSIX thread ids; the profiler gives their low 32 bits as a signed int
MAIN, AUTOGRAD = 0x7FA785898300, 0x7FA367DFF6C0
MS = 1_000_000


def _int32(thread: int) -> int:
    low = thread & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


class Raw:
    def __init__(self, name, device, start, duration, corr, thread=0):
        self._v = dict(name=name, device_type=device, start_ns=start,
                       duration_ns=duration, correlation_id=corr,
                       linked_correlation_id=0,
                       device_resource_id=_int32(thread))

    def __getattr__(self, key):
        if key == "_v" or key not in self._v:
            raise AttributeError(key)
        return lambda: self._v[key]


def kernel(name, start, duration, corr):
    return Raw(name, CUDA, start * MS, duration * MS, corr)


def launch(corr, at, thread, name="cudaLaunchKernel"):
    return Raw(name, CPU, at * MS, MS // 100, corr, thread)


# one step, in ms: the root on the main thread [1, 99]; forward attention
# [2, 20] and ffn [20, 40]; on the autograd thread ffn.bwd [50, 60] and
# attention.bwd [60, 80]; the update [85, 95]
SPANS = [Span("workload.sgd_step", 1 * MS, 99 * MS, MAIN, None, 0),
         Span("workload.attention", 2 * MS, 20 * MS, MAIN, 0, 0),
         Span("workload.ffn", 20 * MS, 40 * MS, MAIN, 0, 0),
         Span("workload.ffn.bwd", 50 * MS, 60 * MS, AUTOGRAD, None, 0),
         Span("workload.attention.bwd", 60 * MS, 80 * MS, AUTOGRAD, None, 0),
         Span("workload.sgd_update", 85 * MS, 95 * MS, MAIN, 0, 0)]
BENCH_SPANS = [("bench.window", 0, 200 * MS),
               ("bench.enqueue_step", 0, 99 * MS),
               ("bench.sync", 99 * MS, 200 * MS)]
# (kernel, device start, duration, launch thread, host time) in ms; None:
# no launch record
WORK = [
    ("elementwise_kernel_norm", 10, 2, MAIN, 3),          # attention
    ("nvjet_tst_256x128", 12, 5, MAIN, 4),                # attention, gemm
    ("flash_fwd_wgmma_kernel", 17, 3, MAIN, 5),           # attention, K1
    ("vectorized_elementwise_gelu", 30, 4, MAIN, 25),     # ffn
    ("embedding_gather", 5, 1, MAIN, 1.5),                # root alone
    ("CatArrayBatchedCopy", 100, 6, AUTOGRAD, 82),        # outside
    ("cunn_SoftMaxBackward", 110, 3, AUTOGRAD, 55),       # ffn.bwd
    ("direct_copy_kernel", 120, 2, AUTOGRAD, 70),         # attention.bwd
    ("Memcpy DtoD", 125, 1, MAIN, 30),                    # ffn
    ("sgd_mul_add", 130, 7, MAIN, 90),                    # sgd
    ("lost_kernel", 140, 2, None, None),                  # unmatched
    ("before_window", -3, 1, MAIN, 0.5),                  # clipped away
]


def _raw():
    raw = []
    for corr, (name, start, dur, thread, host) in enumerate(WORK, start=1):
        raw.append(kernel(name, start, dur, corr))
        if thread is not None:
            raw.append(launch(corr, host, thread,
                              "cudaMemcpyAsync" if "Memcpy" in name
                              else "cudaLaunchKernel"))
    # the profiler's own records may carry a launch's id
    raw.append(Raw("Activity Buffer Request", CPU, 150 * MS, MS, 1, 0))
    raw.append(Raw("cudaStreamSynchronize", CPU, 150 * MS, MS, 0, MAIN))
    return raw


def _placed():
    raw = _raw()
    return attribution.place(attribution.read_launches(raw, (0, 200 * MS)),
                             SPANS)


def test_each_kernel_lands_under_the_innermost_span_of_its_thread():
    placed = _placed()
    assert placed.by_bucket() == {
        "workload.attention": 10 * MS, "workload.ffn": 5 * MS,
        "workload.sgd_step": 1 * MS, "outside": 6 * MS,
        "workload.ffn.bwd": 3 * MS, "workload.attention.bwd": 2 * MS,
        "workload.sgd_update": 7 * MS, "unmatched": 2 * MS}
    assert placed.by_bucket("gemm") == {"workload.attention": 5 * MS}
    assert sorted(attribution.top_kernels(placed, 1)["attention"]) == [
        ["direct_copy_kernel", 2.0], ["elementwise_kernel_norm", 2.0]]
    assert placed.matched_share == pytest.approx(34 / 36)
    # the kernel launched before the root ran before the window too
    assert placed.in_root_share == 1.0
    # autograd-thread `other` work: 6 outside, 5 under .bwd spans
    assert placed.bwd_share == pytest.approx(5 / 11)


def test_the_modules_and_the_remainder_add_up_to_nongemm():
    placed = _placed()
    other = attribution.module_ms(placed, units=2, kernel_group="other")
    assert other == pytest.approx({
        "attention": 2.0, "ffn": 4.0, "root": 0.5, "outside": 3.0,
        "sgd": 3.5, "unmatched": 1.0})
    events = read_events(_raw(), BENCH_SPANS)
    view = metrics.View("train", {}, block, [(1, 1, "flash")] * 2, events,
                        None)
    assert sum(other.values()) == pytest.approx(metrics.nongemm_ms(view))


def test_the_join_keeps_the_device_work_read_events_keeps():
    raw = _raw()
    linked = attribution.read_launches(raw, (0, 200 * MS)).device
    assert [d[:3] for d in linked] == read_events(raw, BENCH_SPANS).device


def test_every_reader_reads_the_same_with_the_ports_spans_beside():
    model = json.loads((BENCH / "configs" / "pythia-1.4b.json")
                       .read_text())["model"]
    peak = lookup("NVIDIA H100 80GB HBM3")
    plain = read_events(_raw(), BENCH_SPANS)
    joined = read_events(_raw(), BENCH_SPANS)
    joined.spans += [(s.name, s.start_ns, s.end_ns) for s in SPANS]
    for kind in ("train", "score"):
        views = [metrics.View(kind, model, block, [(8, 2048, "flash")] * 2,
                              ev, peak)
                 for ev in (plain, joined)]
        for read in (lambda v: metrics.mfu(v, kind),
                     lambda v: metrics.gemm_roofline(v, kind),
                     lambda v: metrics.flash_roofline(v, kind),
                     lambda v: metrics.device_idle(v, kind),
                     metrics.nongemm_ms):
            assert read(views[0]) == read(views[1])
    # the idle time is named by the port's spans where they are open
    assert dict(plain.idle_gaps()).keys() == {"bench.enqueue_step",
                                              "bench.sync"}
    assert "workload.attention" in dict(joined.idle_gaps())


@pytest.mark.parametrize("name", ["tiny-moe.train", "tiny-dense.score"])
def test_split_on_the_cpu_records_the_ports_spans_and_reads_no_metric(
        tmp_path, name):
    torch.set_num_threads(2)
    checkout = make(tmp_path)
    import split
    out = split.split(load_cell(name, checkout), 5, 0.2, True, "cpu",
                      time.perf_counter())
    assert out["correct"] is True
    # on the CPU no device work is traced: no metric reads, nothing to join
    assert out["metrics"] == {}
    assert out["split"] == {"other": {}, "all": {}}
    assert out["joins"]["spans"] > out["joins"]["units"] > 0
    assert out["breakdown"]["idle_gaps"][0][0].startswith("workload.")
    if name.endswith(".train"):
        assert 0 <= out["counts"]["moe.dropped"] < out["counts"]["moe.routed"]
    else:
        assert out["counts"] == {}
    unrecorded = split.split(load_cell(name, checkout), 5, 0.2, False, "cpu",
                             time.perf_counter())
    assert "split" not in unrecorded and unrecorded["correct"] is True
