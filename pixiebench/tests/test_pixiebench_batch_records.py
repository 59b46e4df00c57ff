"""The readers of the program's batch records (``records.py`` and the
span and counter metrics): a mean a batch over the answers returned
before the profiler started, nothing where the answers carry no record,
and a number for each on a traced run of each cell cut to the CPU."""

from types import SimpleNamespace

import pytest

from pixiebench import harness, manifest
from pixiebench.tests import tinycell

SPAN_METRICS = {"walk_loop_ms": "pixie.walk", "boost_ms": "pixie.boost",
                "topk_ms": "pixie.topk"}
NEW = {
    "homefeed-8pin-open": ["walk_loop_ms.open", "boost_ms.open", "topk_ms.open",
                           "host_syncs_per_batch.open", "walk_chunks_per_batch.open"],
    "related-1pin-closed32": ["walk_loop_ms.closed", "boost_ms.closed", "topk_ms.closed",
                              "batch_device_ms.closed", "host_syncs_per_batch.closed",
                              "walk_chunks_per_batch.closed"],
}


def span(start, end):
    return SimpleNamespace(parent="pixie.batch", start_ms=start, end_ms=end)


def record(walk, syncs, chunks):
    return SimpleNamespace(
        spans={"pixie.batch": span(0.0, 100.0), "pixie.walk": span(1.0, 1.0 + walk),
               "pixie.boost": span(50.0, 70.0), "pixie.topk": span(70.0, 90.0)},
        host_syncs={"dispatch.h2d": 5, "walk.live_rows": syncs - 5}, chunks=chunks)


def run_of(answers, done):
    run = harness.Run(loop="closed", seconds=10.0, setup_s=1.0, answers=answers,
                      done_at=done, due_at={})
    run.traced_from = 5.0
    return run


def test_readers_take_one_value_a_batch_before_the_profiler():
    a, b, c = record(10.0, 18, 4), record(30.0, 16, 2), record(99.0, 99, 99)
    q = lambda seq, rec: SimpleNamespace(batch_seq=seq, trace=rec)
    answers = {0: q(0, a), 1: q(0, a), 2: q(0, a), 3: q(1, b), 4: q(2, c)}
    run = run_of(answers, {0: 1.0, 1: 1.0, 2: 1.0, 3: 2.0, 4: 6.0})   # 4: under the profiler
    read = lambda name: manifest.reader(name)(run)
    for suffix in ("open", "closed"):
        assert read(f"walk_loop_ms.{suffix}") == pytest.approx(20.0)
        assert read(f"boost_ms.{suffix}") == pytest.approx(20.0)
        assert read(f"topk_ms.{suffix}") == pytest.approx(20.0)
        assert read(f"host_syncs_per_batch.{suffix}") == pytest.approx(17.0)
        assert read(f"walk_chunks_per_batch.{suffix}") == pytest.approx(3.0)
    assert read("batch_device_ms.closed") == pytest.approx(100.0)


def test_readers_find_nothing_without_records():
    # the parent's answers carry no record; a batch may hold no such span
    bare = {0: SimpleNamespace(batch_seq=0, compute_ms=5.0, wait_ms=1.0)}
    lone = record(1.0, 18, 4)
    lone.spans = {"pixie.batch": lone.spans["pixie.batch"]}
    per_query = {0: SimpleNamespace(batch_seq=0, trace=lone)}
    names = [n for cell in NEW.values() for n in cell]
    for name in names:
        assert manifest.reader(name)(run_of(bare, {0: 1.0})) is None
        assert manifest.reader(name)(run_of({}, {})) is None
    for name in ("walk_loop_ms.open", "boost_ms.closed", "topk_ms.open"):
        assert manifest.reader(name)(run_of(per_query, {0: 1.0})) is None


@pytest.mark.parametrize("cell", sorted(NEW))
def test_a_traced_run_reads_every_new_metric(cell):
    out = tinycell.run(cell, trace=True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    want = {m.name for m in manifest.cell(cell).per_layer}
    assert set(NEW[cell]) <= want and set(NEW[cell]) <= set(got)
    suffix = cell.split("-")[-1].startswith("open") and "open" or "closed"
    for prefix in SPAN_METRICS:
        assert got[f"{prefix}.{suffix}"] > 0.0
    chunks = got[f"walk_chunks_per_batch.{suffix}"]
    max_chunks = tinycell.tiny(cell).config["walk"]
    max_chunks = -(-max_chunks["n_steps"] // (max_chunks["n_walkers"] * max_chunks["chunk_steps"]))
    assert chunks == int(chunks) and 1 <= chunks <= max_chunks
    # the batch-native path's sites: 14 a batch besides one read a chunk run
    # and one more where early stops ended the batch
    syncs = got[f"host_syncs_per_batch.{suffix}"]
    assert syncs == 14 + chunks + (chunks < max_chunks)
    if suffix == "closed":
        inner = sum(got[f"{p}.closed"] for p in SPAN_METRICS)
        assert inner <= got["batch_device_ms.closed"] <= got["batch_compute_ms.closed"]
