"""The metric arithmetic: percentiles, rates, trace sums and rooflines."""

import math
from types import SimpleNamespace

import pytest

from pixiebench import devtrace, harness, manifest, roofline, stats


def make_run(due, done, seconds=10.0, answers=None):
    return harness.Run(loop="open", seconds=seconds, setup_s=1.5, answers=answers or {},
                       done_at=done, due_at=due)


def test_percentiles_count_unanswered_requests_beyond_every_limit():
    due = {i: float(i) for i in range(20)}
    done = {i: i + 0.010 * (i + 1) for i in range(19)}          # request 19 never answered
    run = make_run(due, done)
    lat = run.latencies_ms
    assert lat[19] == math.inf
    p95 = manifest.reader("latency_p95_ms")(run)
    p50 = manifest.reader("latency_p50_ms")(run)
    assert p95 == pytest.approx(190.0)              # 19th of 20 by nearest rank
    assert p50 == pytest.approx(100.0)
    done[19] = 19.5
    assert manifest.reader("latency_p95_ms")(make_run(due, done)) == pytest.approx(190.0)
    del done[18]                                    # one unanswered: the 20th value
    assert manifest.reader("latency_p95_ms")(make_run(due, done)) == pytest.approx(500.0)
    del done[17]                                    # two: the 19th as well
    assert manifest.reader("latency_p95_ms")(make_run(due, done)) == math.inf


def test_nearest_rank():
    assert stats.nearest_rank([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.nearest_rank([1.0], 95) == 1.0
    assert stats.nearest_rank(list(range(1, 101)), 95) == 95


def test_throughput_is_all_answers_over_the_whole_window():
    due = {i: 0.0 for i in range(10)}
    done = {i: 0.5 * i for i in range(10)}          # answers at 0 .. 4.5 s
    run = make_run(due, done, seconds=4.0)
    assert run.answered_in_window == 9              # 4.5 s is past the window
    assert manifest.reader("throughput_qps")(run) == pytest.approx(9 / 4.0)


def test_batch_compute_is_a_mean_over_batches():
    q = lambda seq, ms, wait: SimpleNamespace(batch_seq=seq, compute_ms=ms, wait_ms=wait)
    answers = {0: q(0, 10.0, 1.0), 1: q(0, 10.0, 3.0), 2: q(1, 40.0, 5.0),
               3: q(2, 99.0, 99.0)}
    run = make_run({}, {0: 1.0, 1: 1.0, 2: 2.0, 3: 6.0}, answers=answers)
    run.traced_from = 5.0           # request 3 came back under the profiler
    assert manifest.reader("batch_compute_ms.open")(run) == pytest.approx(25.0)
    assert manifest.reader("batch_compute_ms.closed")(run) == pytest.approx(25.0)
    assert manifest.reader("server_wait_ms")(run) == pytest.approx(3.0)


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def host(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


EVENTS = [
    host("bench.harvest", 0, 1000, "user_annotation"),
    host("cudaStreamSynchronize", 100, 50, "cuda_runtime"),
    kernel("void walk_steps_fused_kernel<true>(int const*, int*)", 10, 40),  # busy 10..70
    kernel("(anonymous namespace)::update_high_kernel(int const*, int const*)", 30, 40),
    kernel("walk_steps_fused_kernel(int const*, int*)", 200, 100),  # gap 70..200, mid 135
    {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 400, "dur": 10},
]


def test_trace_summary_busy_gaps_and_kernel_time():
    s = devtrace.summarize(EVENTS)
    assert s.n_device_ops == 4
    assert s.busy_s == pytest.approx((60 + 100 + 10) / 1e6)
    assert devtrace.kernel_seconds(s, "walk_steps_fused_kernel") == pytest.approx(140e-6)
    assert devtrace.kernel_seconds(s, "update_high_kernel") == pytest.approx(40e-6)
    owners = dict(s.idle_gaps)
    assert owners["cudaStreamSynchronize"] == pytest.approx(130e-6)   # mid 135 in 100..150
    assert owners["bench.harvest"] == pytest.approx(100e-6)           # mid 350
    b = devtrace.breakdown(s)
    assert b["device_ops"][0][1] == pytest.approx(100e-6)
    assert len(b["device_ops"]) <= devtrace.TOP and len(b["idle_gaps"]) <= devtrace.TOP


def test_roofline_reads_100_percent_at_the_least_time_and_never_more():
    work = roofline.Work(walker_steps=65536 * 8 * 4, query_chunks=32,
                         events=65536 * 8 * 3, distinct_bins=400_000)
    least = roofline.walk_least_s(work, 8)
    ops = 32 * 8 * 72 + 4 * 73 * work.walker_steps
    assert least == pytest.approx(ops / roofline.INT32_OPS_PER_S)   # operations bound it
    assert roofline.share(least, least) == pytest.approx(100.0)
    assert roofline.share(least, 2 * least) == pytest.approx(50.0)
    c = roofline.counter_least_s(work)
    assert c == pytest.approx((12 * work.events + 8 * work.distinct_bins) / 3.35e12)
    assert roofline.share(0.0, 1.0) is None and roofline.share(1.0, 0.0) is None


def test_roofline_readers_read_the_stretch():
    s = devtrace.summarize(EVENTS)
    work = roofline.Work(walker_steps=1000, query_chunks=4, events=900,
                         distinct_bins=700)
    run = make_run({}, {})
    run.trace, run.trace_window_s, run.stretch = s, 1e-3, [0, 1]
    run.config = {"walk": {"chunk_steps": 8}}
    run._work_fn = lambda: work
    walk_share = manifest.reader("walk_steps_fused_roofline")(run)
    assert walk_share == pytest.approx(100 * roofline.walk_least_s(work, 8) / 140e-6)
    counter_share = manifest.reader("visit_counter_update_high_roofline")(run)
    assert counter_share == pytest.approx(100 * roofline.counter_least_s(work) / 40e-6)
    assert manifest.reader("device_ops_per_request")(run) == pytest.approx(2.0)
    idle = manifest.reader("device_idle_share")(run)
    assert idle == pytest.approx(100 * (1 - 170e-6 / 1e-3))


def test_readers_find_nothing_without_a_trace():
    run = make_run({}, {})
    for name in ("walk_steps_fused_roofline", "visit_counter_update_high_roofline",
                 "device_ops_per_request", "device_idle_share", "server_wait_ms",
                 "latency_p95_ms"):
        assert manifest.reader(name)(run) is None
