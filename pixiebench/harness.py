"""One run of a Pixie cell (kind ``pixie``): set-up, the measured window,
the check, the metrics.

Set-up draws the graph from the seed on the device, compiles it with the
program's ``build_graph``, starts a ``PixieServer`` with the
configuration's buckets and walk (``backend="pallas"``: the hand kernels
on the card), draws the traffic's payloads, and serves one request of the
cell's bucket shape, which loads the kernels (and builds them with
``nvcc`` into the checkout's ``build/`` on a checkout's first run).

The window (``cellrun``'s drivers) runs ``submit`` / ``pump`` / ``harvest``
from one thread:

  * open loop: each request is submitted at its scheduled time (stamped
    with it, so the server's queue wait counts a late submit), every
    dispatchable batch is pumped, then harvested; a request's latency
    runs from its scheduled arrival to the host clock after the harvest
    that returned it.  After the window the run keeps serving until every
    request due in it is answered, for at most ``drain_s``;
  * closed loop: ``callers`` requests are out at all times; each answer
    sends that caller's next request at once.  The window closes at the
    first harvest past ``--seconds``, so it holds whole cycles of ``pump``
    and ``harvest`` (each returns ``callers`` answers at once), and
    throughput counts every answer over the whole window.

With ``--trace 1`` a stretch of the window (from a third of it in, at
most ``PROFILE_S``) runs under ``torch.profiler``; it starts and stops
between harvests, with nothing in flight.  After the window the peak
memory is read, the program's state is dropped, and the reference
(``reference.py``) compiles the graph again from the same seed, is held
against the program's compile, and redoes a sample of the answers drawn
from the seed.  The metrics' readers (``metrics/``) read the ``Run``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from pixiebench import cellrun, checks, graphgen, reference, roofline
from pixiebench import traffic as traffic_lib
# every kind's; ``sweep.py`` and the tests take ``Run`` and ``_Stretch`` from here
from pixiebench.cellrun import Run, _Stretch, _sync, clock

WARM_ID = 2**31 - 2      # the warm-up request's id; every window id is smaller


def padded(pay: traffic_lib.Payloads, j: int, slots: int):
    """Payload ``j`` as its bucket holds it: ``slots`` wide, -1 / 0 padded."""
    pins = np.full(slots, -1, np.int32)
    weights = np.zeros(slots, np.float32)
    k = pay.pins.shape[1]
    pins[:k], weights[:k] = pay.pins[j], pay.weights[j]
    return pins, weights


def _submit(server, pay, j: int, rid: int, now: float) -> None:
    got = server.submit(pay.pins[j].tolist(), pay.weights[j].tolist(),
                        int(pay.feats[j]), now=now, req_id=rid)
    if got is None:
        raise RuntimeError(f"request {rid} refused by admission control")


def _program_graph(config, edges):
    from repro_torch.core.graph import build_graph

    return build_graph(
        edges.pins, edges.boards, config["n_pins"], config["n_boards"],
        edge_feat=torch.index_select(edges.board_lang, 0, edges.boards),
        n_feats=config["n_langs"],
        edge_feat_b2p=torch.index_select(edges.pin_lang, 0, edges.pins),
    )


def _to_host(graph):
    side = lambda c: reference.Csr(c.offsets.cpu(), c.targets.cpu(), c.feat_bounds.cpu())
    return reference.Graph(side(graph.p2b), side(graph.b2p), graph.n_pins, graph.n_boards,
                           graph.max_pin_degree)


def slots_for(config: dict, n_pins: int) -> int:
    """The slots of the smallest bucket a query of ``n_pins`` pins fits."""
    return min(s for _, s in config["buckets"] if s >= n_pins)


@dataclasses.dataclass
class Replica:
    """A served replica, set up and warm: the program's graph and server,
    and the traffic's payloads."""

    config: dict
    mix: dict
    seed: int
    graph: object
    server: object
    has_edge: torch.Tensor
    pay: traffic_lib.Payloads
    arrivals: Optional[np.ndarray]
    phases: Dict[str, float]


def set_up(cell, seed: int, seconds: float, device: torch.device, trace: bool) -> Replica:
    """Draw and compile the graph, start the server, make the traffic and
    serve one request of the cell's bucket shape."""
    from repro_torch.core.walk import WalkConfig
    from repro_torch.serving.server import PixieServer

    config, mix = cell.config, cell.traffic
    traffic_lib.validate(mix)
    phases = {}
    t = clock()
    edges = graphgen.draw(config, seed, device)
    has_edge = graphgen.pins_with_edges(edges, config["n_pins"])
    _sync(device)
    phases["graph_draw_s"], t = clock() - t, clock()
    graph = _program_graph(config, edges)
    del edges
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    phases["graph_compile_s"], t = clock() - t, clock()
    server = PixieServer(
        graph, WalkConfig(**config["walk"]), seed=seed,
        buckets=[tuple(b) for b in config["buckets"]],
        max_wait_ms=config["max_wait_ms"],
    )
    rep = Replica(config, mix, seed, graph, server, has_edge, None, None, phases)
    traffic_for(rep, mix, seconds)
    _submit(server, rep.pay, 0, WARM_ID, clock())
    server.flush()
    _sync(device)
    if trace:
        cellrun.warm_profiler(device)
    phases["warmup_s"] = clock() - t
    return rep


def traffic_for(rep: Replica, mix: dict, seconds: float) -> None:
    """The arrivals (open loop) and payloads of ``mix`` for a window."""
    rep.mix = mix
    if mix["loop"] == "open":
        rep.arrivals = traffic_lib.arrivals(mix, seconds, rep.seed)
        n = len(rep.arrivals)
    else:
        n = mix["pool"]
    rep.pay = traffic_lib.payloads(mix, n, rep.has_edge, rep.config["n_langs"], rep.seed)


def serve_window(rep: Replica, seconds: float, stretch: "_Stretch"):
    """The measured window -> ``(answers, done_at, due_at, order, seconds)``."""
    def send(j, rid, now):
        _submit(rep.server, rep.pay, j, rid, now)

    if rep.mix["loop"] == "open":
        return cellrun.open_loop(rep.server, rep.arrivals, send, seconds,
                                 rep.mix["drain_s"], stretch)
    return cellrun.closed_loop(rep.server, send, rep.pay.pins.shape[0], rep.mix["callers"],
                               seconds, stretch)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float) -> dict:
    """One run; returns the result line's fields and the checks' numbers."""
    start_s = clock() - t_start        # interpreter, imports, argument checks
    rep = set_up(cell, seed, seconds, device, trace)
    config, mix, phases, pay = rep.config, rep.mix, rep.phases, rep.pay
    phases["start_s"] = start_s
    setup_s = clock() - t_start

    t_window = clock()
    stretch = _Stretch(trace, t_window, seconds, device)
    answers, done_at, due_at, order, window = serve_window(rep, seconds, stretch)
    peak = cellrun.memory_peak(device)

    per_batch = sorted({r.batch_seq: r.compute_ms for r in answers.values()}.values())
    if per_batch:
        phases["batches"] = len(per_batch)
        phases["batch_compute_ms_p50"] = per_batch[len(per_batch) // 2]
    run = Run(loop=mix["loop"], seconds=window, setup_s=setup_s, answers=answers,
              done_at=done_at, due_at=due_at, config=config)
    cellrun.read_trace(run, stretch, order, t_window, phases)
    # the program's compiled graph waits on the host for its comparison,
    # so the reference's compile has the card
    graph = _to_host(rep.graph)
    del stretch, rep
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the program's state goes, the reference works it all again
    t = clock()
    served = {rid: (r.scores, r.ids) for rid, r in answers.items()}
    slots = slots_for(config, pay.pins.shape[1])
    edges = graphgen.draw(config, seed, device)
    ref = reference.compile_graph(edges.pins, edges.boards, edges.pin_lang,
                                  edges.board_lang, config["n_pins"],
                                  config["n_boards"], config["n_langs"])
    del edges
    numbers = {"csr_mismatch": checks.csr_mismatch(graph, ref)}
    del graph
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walk = reference.walk_from(config)
    pool = pay.pins.shape[0]

    def redo(rid, rank=True):
        pins, weights = padded(pay, rid % pool, slots)
        return reference.recommend(ref, pins, weights, int(pay.feats[rid % pool]),
                                   reference.request_key(seed, rid, device), walk,
                                   rank=rank)

    sampled = checks.sample(answers, mix["check_requests"], seed)
    expected = {}
    for rid in sampled:
        a = redo(rid)
        expected[rid] = (a.scores.numpy(), a.ids.numpy())
    numbers.update(checks.compare(served, expected))
    numbers["unanswered"] = sum(1 for rid in due_at if rid not in answers)
    phases["reference_s"] = clock() - t

    def stretch_work():
        counts = [0, 0, 0, 0]
        for rid in run.stretch:
            a = redo(rid, rank=False)
            counts[0] += int(a.steps_taken.sum())
            counts[1] += len(a.chunks)
            counts[2] += sum(e for e, _ in a.chunks)
            counts[3] += sum(b for _, b in a.chunks)
        return roofline.Work(*counts)

    run._work_fn = stretch_work
    metrics = cellrun.read_metrics(cell, run, trace, phases)
    del ref
    return cellrun.result(cell, run, numbers, checks.LIMITS, metrics, attempted=len(due_at),
                          failed=numbers["unanswered"], peak=peak, device=device,
                          phases=phases)
