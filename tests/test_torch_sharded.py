"""The port's node-range-sharded engine against the JAX package.

Held bit for bit on ``small_test_graph`` (integers exactly, and scores
exactly too: the boost is the same float64-rounded chain):

  * the ``walk_hop`` twin against ``ref.walk_hop_ref`` and against the
    reference's ``walk_hop_fused`` in interpret mode, on seeded inputs
    with gated-off lanes, degree-0 rows and ``row_base > 0``;
  * ``shard_graph`` for 1-4 shards, indivisible id spaces and empty rows;
  * ``_route`` under starved capacity;
  * ``pixie_walk_sharded_batched`` over ``LocalFabric`` for 2 and 4
    shards on both walk backends, board counting on and early stop
    firing, with generous slack (no drops), starved slack (drops) and a
    ``shard_dead_at`` schedule (kills): folded counts, board counts,
    ``steps_taken``, ``n_high``, ``dropped``, ``max_occupancy`` and
    ``killed``; one shard in-process against the reference's 1-device
    mesh;
  * the sharded ``serve_batch`` branch, ``recommend_sharded_batched``,
    ``pixie_walk_sharded`` and their refusals;
  * a sharded ``PixieServer`` through kill, revive and ``dead_shards``,
    and a seeded ``run_open_loop`` with shard deaths;
  * ``ProcessGroupFabric`` over two gloo processes against
    ``LocalFabric(2)``.

The reference's multi-shard runs need several devices, which JAX fixes
when it starts: they run once per module in a subprocess with four fake
CPU devices (``test_distributed._run``), each reference call jitted so it
compiles once, and come back as JSON.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import walk as jwalk
from repro.core.graph import build_graph as jbuild_graph
from repro.graphs.synthetic import small_test_graph
from repro.kernels import ref as jref
from repro.kernels.walk_step import walk_hop_fused as jwalk_hop_fused
from repro.launch.mesh import make_mesh_compat, set_mesh_compat
from repro_torch.core import counter as tcounter
from repro_torch.core import distributed as tdist
from repro_torch.core import prng, service as tservice
from repro_torch.core import walk as twalk
from repro_torch.core.graph import build_graph as tbuild_graph
from repro_torch.graphs import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.kernels import walk_step as tws
from repro_torch.serving import traffic as ttraffic
from repro_torch.serving.resilience import ResilienceConfig
from repro_torch.serving.server import PixieServer
from test_distributed import _run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = 2**31 - 1
CPU = "cpu"

# the engine cases: (n_shards, case) -> (slack, shard_dead_at)
ENGINE_CASES = {
    (2, "roomy"): (4.0, [NEVER, NEVER]),
    (2, "starved"): (0.05, [NEVER, NEVER]),
    (2, "dead"): (4.0, [NEVER, 2]),
    (4, "roomy"): (8.0, [NEVER] * 4),
    (4, "starved"): (0.05, [NEVER] * 4),
    (4, "dead"): (8.0, [NEVER, 5, NEVER, 2]),
}
ENGINE_CFG = dict(n_steps=6144, n_walkers=64, chunk_steps=4, n_p=30, n_v=3,
                  bias_beta=0.0, count_boards=True)
SERVE_CFG = dict(n_steps=8192, n_walkers=256, chunk_steps=4, n_p=80, n_v=3,
                 bias_beta=0.0, top_k=25)
SERVE_CASES = {"roomy": (4.0, None), "starved": (0.05, None),
               "dead": (4.0, [NEVER, 2])}
RECIPE_CASES = {"starved": 0.05, "roomy": 8.0}
RECIPE = dict(n_supersteps=32, walkers_per_shard=128, top_k=25)
SERVER_CFG = dict(n_steps=4096, n_walkers=128, chunk_steps=4, n_p=60, n_v=3,
                  bias_beta=0.0, top_k=15)
OPEN_LOOP = dict(offered_qps=2000.0, n_requests=12, seed=2, max_pins=4,
                 n_feats=3)
CHAOS = dict(seed=4, n_shard_deaths=2, n_shards=2, death_max_superstep=6)
ROUTE_CAP = 4

_REFERENCE_BODY = """
    import dataclasses
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.graphs.synthetic import small_test_graph, top_degree_pins
    from repro.core import counter as C, distributed as D, service as S
    from repro.core import walk as W
    from repro.serving import traffic as T
    from repro.serving.server import PixieServer

    K = json.loads('''%s''')
    out = {}
    sg = small_test_graph()
    g = sg.graph
    qp = jnp.asarray(K["qp"], jnp.int32)
    qw = jnp.asarray(K["qw"], jnp.float32)
    uf = jnp.zeros((2,), jnp.int32)
    keys = jax.random.split(jax.random.key(7), 2)
    lst = lambda a: np.asarray(a).tolist()

    cfg = W.WalkConfig(**K["engine_cfg"])
    for n_shards in (2, 4):
        mesh = make_mesh_compat((n_shards,), ("model",))
        shg = D.shard_graph(g, n_shards)
        fns = {}
        for case, (slack, dead) in K["engine_cases"][str(n_shards)].items():
            if slack not in fns:
                fns[slack] = jax.jit(lambda ks, dd, slack=slack:
                    D.pixie_walk_sharded_batched(
                        shg, qp, qw, ks, cfg, mesh, slack=slack,
                        shard_dead_at=dd))
            with set_mesh_compat(mesh):
                res = fns[slack](keys, jnp.asarray(dead, jnp.int32))
            fold = lambda c, d, n: C.fold_sharded_counts(c, 2, 4, d)[..., :n]
            out[f"engine/{n_shards}/{case}"] = dict(
                counts=lst(fold(res.counts, shg.pins_per_shard, g.n_pins)),
                board_counts=lst(fold(res.board_counts, shg.boards_per_shard,
                                      g.n_boards)),
                steps_taken=lst(res.steps_taken), n_high=lst(res.n_high),
                dropped=int(res.dropped), max_occupancy=int(res.max_occupancy),
                killed=int(res.killed))

    mesh = make_mesh_compat((2,), ("model",))
    shg = D.shard_graph(g, 2)
    scfg = W.WalkConfig(**K["serve_cfg"])
    for case, (slack, dead) in K["serve_cases"].items():
        fn = jax.jit(lambda k, dd, slack=slack: S.serve_batch(
            shg, qp, qw, uf, k, scfg, with_stats=True, mesh=mesh,
            slack=slack, shard_dead_at=dd))
        with set_mesh_compat(mesh):
            r = fn(jax.random.key(11),
                   None if dead is None else jnp.asarray(dead, jnp.int32))
        out[f"serve/{case}"] = [lst(x) for x in r]
    with set_mesh_compat(mesh):
        r = jax.jit(lambda ks: D.recommend_sharded_batched(
            shg, qp, qw, ks, scfg, mesh, slack=0.05,
            shard_dead_at=jnp.asarray([2, %d], jnp.int32)))(keys)
    out["recommend/starved_dead"] = [lst(x) for x in r]
    for case, slack in K["recipe_cases"].items():
        wcfg = D.ShardedWalkConfig(slack=slack, **K["recipe"])
        with set_mesh_compat(mesh):
            r = jax.jit(lambda k: D.pixie_walk_sharded(
                shg, qp[0], qw[0], k, wcfg, mesh))(jax.random.key(3))
        out[f"recipe/{case}"] = [lst(r.top_scores), lst(r.top_pins),
                                 int(r.dropped)]

    # _route under starved capacity, two shards
    dest = jnp.asarray(K["route_dest"], jnp.int32)
    pay = jnp.asarray(K["route_pay"], jnp.int32)
    def route(d, p):
        v, (x,), dr, occ = D._route("model", 2, K["route_cap"], d[0], (p[0],))
        return v[None], x[None], dr[None], occ[None]
    sp = P("model", None)
    r = jax.jit(shard_map(route, mesh=mesh, in_specs=(sp, sp),
                          out_specs=(sp, sp, P("model"), P("model")),
                          check_rep=False))(dest, pay)
    out["route"] = [lst(x) for x in r]

    # a sharded replica: healthy, one shard killed, revived
    server_cfg = W.WalkConfig(**K["server_cfg"])
    with set_mesh_compat(mesh):
        srv = PixieServer(shg, server_cfg, batch_size=2, n_slots=4, seed=5,
                          mesh=mesh, slack=4.0)
        def serve_round():
            for rid, (p, w) in enumerate(K["server_reqs"]):
                srv.submit(p, w, req_id=rid, now=0.0)
            return [[lst(r.scores), lst(r.ids)] for r in srv.flush(now=0.0)]
        healthy = serve_round()
        srv.kill_shard(1, at_superstep=2)
        dead_list = srv.dead_shards()
        killed = serve_round()
        srv.revive_shards()
        revived = serve_round()
    out["server"] = dict(healthy=healthy, killed=killed, revived=revived,
                         dead_shards=dead_list)

    # a seeded open loop with shard deaths on a sharded replica
    reqs = T.poisson_requests(top_degree_pins(sg, 12).astype(np.int32),
                              T.OpenLoopConfig(**K["open_loop"]))
    faults = T.sample_fault_schedule(T.ChaosConfig(
        horizon_s=reqs[-1].t_arrival, **K["chaos"]))
    with set_mesh_compat(mesh):
        srv = PixieServer(shg, server_cfg, seed=5, mesh=mesh, slack=4.0,
                          buckets=[(2, 2), (2, 4)])
        rep = T.run_open_loop(srv, reqs, faults=faults)
    out["open_loop"] = dict(
        served=rep.n_served, dropped=rep.n_dropped,
        deaths=[[e.shard, e.at_superstep]
                for e in faults.of_kind("shard_death")],
        dead_shards=srv.dead_shards(),
        results={str(k): [lst(v.scores), lst(v.ids), v.batch_seq]
                 for k, v in rep.results.items()})
    print(json.dumps(out))
"""


def _queries():
    sg = small_test_graph(0)
    from repro.graphs.synthetic import top_degree_pins

    qs = [int(q) for q in top_degree_pins(sg, 4)]
    qp = [[qs[0], qs[1], -1, -1], [qs[2], qs[3], qs[0], -1]]
    qw = [[1.0, 0.7, 0.0, 0.0], [1.0, 0.5, 0.25, 0.0]]
    reqs = [([qs[0], qs[1]], [1.0, 0.6]), ([qs[2]], [1.0]), ([qs[3]], [0.8])]
    return qp, qw, reqs


def _route_inputs():
    rng = np.random.default_rng(5)
    dest = rng.integers(0, 3, (2, 24)).astype(np.int32)   # 2 = nowhere
    pay = rng.integers(0, 1000, (2, 24)).astype(np.int32)
    return dest, pay


@pytest.fixture(scope="module")
def reference():
    qp, qw, reqs = _queries()
    dest, pay = _route_inputs()
    shared = dict(
        qp=qp, qw=qw, engine_cfg=ENGINE_CFG, serve_cfg=SERVE_CFG,
        engine_cases={str(s): {c: v for (n, c), v in ENGINE_CASES.items()
                               if n == s} for s in (2, 4)},
        serve_cases=SERVE_CASES, recipe_cases=RECIPE_CASES, recipe=RECIPE,
        route_dest=dest.tolist(), route_pay=pay.tolist(),
        route_cap=ROUTE_CAP, server_cfg=SERVER_CFG, server_reqs=reqs,
        open_loop=OPEN_LOOP, chaos=CHAOS,
    )
    return _run(4, _REFERENCE_BODY % (json.dumps(shared), NEVER))


@pytest.fixture(scope="module")
def port():
    sg = tsyn.small_test_graph(0, device=CPU)
    qp, qw, reqs = _queries()
    return dict(
        sg=sg, graph=sg.graph,
        qp=torch.tensor(qp, dtype=torch.int32), qw=torch.tensor(qw),
        keys=prng.split(prng.key(7, CPU), 2), reqs=reqs,
    )


def _eq(got, want, what=""):
    np.testing.assert_array_equal(
        np.asarray(got.cpu() if torch.is_tensor(got) else got),
        np.asarray(want), err_msg=what)


# ---------------------------------------------------------------------------
# the hop kernel's twin
# ---------------------------------------------------------------------------


def _hop_inputs(seed, n_shards, l=64, rows=20, all_off=False):
    """Per-shard CSR slices with degree-0 rows (the last row of every
    shard among them half the time), lanes gated off at random with
    garbage positions, and row_base = shard * rows + 37."""
    rng = np.random.default_rng(seed)
    offs, tgts, pos, gate, r, bases = [], [], [], [], [], []
    e_max = 0
    for s in range(n_shards):
        deg = rng.integers(0, 5, rows)
        deg[rng.integers(0, rows, 4)] = 0
        off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        e_max = max(e_max, int(off[-1]))
        offs.append(off)
        base = 37 + s * rows
        bases.append(base)
        g = rng.random(l) < 0.7
        if all_off:
            g[:] = False
        p = base + rng.integers(0, rows, l)
        p[-1] = base + rows - 1                       # a shard's last row
        pos.append(np.where(g, p, rng.integers(-9, 10**6, l)).astype(np.int32))
        gate.append(g)
        r.append(rng.integers(0, 2**32, l, dtype=np.uint64).astype(np.uint32))
    for off in offs:
        tgts.append(rng.integers(0, 500, e_max).astype(np.int32))
    return (np.stack(pos), np.stack(gate), np.stack(r), np.stack(offs),
            np.stack(tgts), np.asarray(bases, np.int32))


@pytest.mark.parametrize("seed,all_off", [(0, False), (1, False), (2, True)])
def test_walk_hop_twin_matches_reference(seed, all_off):
    pos, gate, r, off, tgt, base = _hop_inputs(seed, 3, all_off=all_off)
    t = torch.from_numpy
    r32 = t(r.view(np.int32))
    stacked = tws.walk_hop_ref(t(pos), t(gate), r32, t(off), t(tgt), t(base))
    via_ops = ops.walk_hop_words_plain(t(pos), t(gate), t(r.astype(np.int64)),
                                       t(off), t(tgt), t(base))
    for s in range(3):
        want_t, want_ok = jref.walk_hop_ref(
            jnp.asarray(pos[s]), jnp.asarray(gate[s]), jnp.asarray(r[s]),
            jnp.asarray(off[s]), jnp.asarray(tgt[s]), jnp.asarray(base[s]))
        kern_t, kern_ok = jwalk_hop_fused(
            jnp.asarray(pos[s]), jnp.asarray(gate[s]), jnp.asarray(r[s]),
            jnp.asarray(base[s:s + 1]), jnp.asarray(off[s]),
            jnp.asarray(tgt[s]), block_l=64, interpret=True)
        one = tws.walk_hop_ref(t(pos[s]), t(gate[s]), r32[s], t(off[s]),
                               t(tgt[s]), int(base[s]))
        for got in (one, (stacked[0][s], stacked[1][s]),
                    (via_ops[0][s], via_ops[1][s])):
            _eq(got[0], want_t, "tgt")
            _eq(got[1], want_ok, "ok")
        _eq(one[0], kern_t, "interpret-mode kernel tgt")
        _eq(one[1], kern_ok, "interpret-mode kernel ok")
    if all_off:
        assert not stacked[1].any() and not stacked[0].any()
    else:
        assert stacked[1].any() and not stacked[1].all()


# ---------------------------------------------------------------------------
# shard_graph
# ---------------------------------------------------------------------------


_TINY_EDGES = [(0, 0), (0, 1), (1, 0), (2, 2), (3, 3), (5, 1), (5, 4),
               (6, 6), (8, 2), (9, 6), (9, 0)]


def _both_graphs(which):
    if which == "tiny":     # pins 4, 7 and board 5 have no edges
        pins = np.asarray([e[0] for e in _TINY_EDGES])
        boards = np.asarray([e[1] for e in _TINY_EDGES])
        return (jbuild_graph(pins, boards, n_pins=10, n_boards=7),
                tbuild_graph(pins, boards, 10, 7))
    return small_test_graph(0).graph, tsyn.small_test_graph(0, device=CPU).graph


@pytest.mark.parametrize("which", ["tiny", "small"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_graph_matches_reference(which, n_shards):
    jg, tg = _both_graphs(which)
    want = jdist.shard_graph(jg, n_shards)
    got = tdist.shard_graph(tg, n_shards)
    for name in ("p2b_offsets", "p2b_targets", "b2p_offsets", "b2p_targets"):
        assert getattr(got, name).dtype == torch.int32
        _eq(getattr(got, name), getattr(want, name), name)
    assert (got.n_pins, got.n_boards, got.n_shards, got.max_pin_degree) == (
        want.n_pins, want.n_boards, want.n_shards, want.max_pin_degree)
    assert (got.pins_per_shard, got.boards_per_shard) == (
        want.pins_per_shard, want.boards_per_shard)


def test_shard_graph_past_the_id_space_gives_ghost_rows():
    """A deliberate difference: 5 pins over 4 shards puts shard 3's first
    row past the graph; the reference's slicer fails there, the port
    gives the shard degree-0 ghost rows."""
    pins, boards = np.arange(5), np.asarray([0, 1, 0, 1, 2])
    with pytest.raises(IndexError):
        jdist.shard_graph(jbuild_graph(pins, boards, n_pins=5, n_boards=3), 4)
    got = tdist.shard_graph(tbuild_graph(pins, boards, 5, 3), 4)
    assert got.n_pins == 8
    assert got.p2b_offsets.tolist() == [[0, 1, 2], [0, 1, 2], [0, 1, 1],
                                        [0, 0, 0]]


# ---------------------------------------------------------------------------
# the engine against the reference's multi-device runs
# ---------------------------------------------------------------------------


def test_route_matches_reference_under_starved_capacity(reference):
    dest, pay = _route_inputs()
    v, (x,), dr, occ = tdist._route(
        tdist.LocalFabric(2, device=CPU), 2, ROUTE_CAP,
        torch.from_numpy(dest), (torch.from_numpy(pay),))
    want = reference["route"]
    _eq(v, np.asarray(want[0]).astype(bool), "valid")
    _eq(x, want[1], "payload")
    _eq(dr, want[2], "dropped")
    _eq(occ, want[3], "max_occupancy")
    assert int(dr.sum()) > 0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("n_shards,case", list(ENGINE_CASES))
def test_sharded_engine_matches_reference(reference, port, n_shards, case,
                                          backend):
    slack, dead = ENGINE_CASES[(n_shards, case)]
    g = port["graph"]
    cfg = twalk.WalkConfig(backend=backend, **ENGINE_CFG)
    shg = tdist.shard_graph(g, n_shards)
    res = tdist.pixie_walk_sharded_batched(
        shg, port["qp"], port["qw"], port["keys"], cfg,
        tdist.LocalFabric(n_shards, device=CPU), slack=slack,
        shard_dead_at=torch.tensor(dead, dtype=torch.int32))
    want = reference[f"engine/{n_shards}/{case}"]
    fold = lambda c, d, n: tcounter.fold_sharded_counts(c, 2, 4, d)[..., :n]
    _eq(fold(res.counts, shg.pins_per_shard, g.n_pins), want["counts"])
    _eq(fold(res.board_counts, shg.boards_per_shard, g.n_boards),
        want["board_counts"])
    for name in ("steps_taken", "n_high", "dropped", "max_occupancy",
                 "killed"):
        _eq(getattr(res, name), want[name], name)
    if case == "roomy":
        assert int(res.dropped) == 0 and int(res.killed) == 0
        assert bool((res.n_high > cfg.n_p).any())      # early stop fired
        # drop-free sharding is the unsharded batched engine, bit for bit
        flat = twalk.pixie_random_walk_batched(
            g, port["qp"], port["qw"], torch.zeros(2, dtype=torch.int32),
            port["keys"], cfg)
        _eq(fold(res.counts, shg.pins_per_shard, g.n_pins), flat.counts)
        _eq(res.steps_taken, flat.steps_taken)
        _eq(res.n_high, flat.n_high)
    elif case == "starved":
        assert int(res.dropped) > 0
    else:
        assert int(res.killed) > 0 and int(res.dropped) == 0


def test_healthy_schedule_equals_no_schedule(port):
    """An all-NEVER_DIES schedule is the healthy walk (killed 0), and the
    healthy walk reports no kill tally."""
    shg = tdist.shard_graph(port["graph"], 2)
    cfg = twalk.WalkConfig(**ENGINE_CFG)
    fabric = tdist.LocalFabric(2, device=CPU)
    run = lambda dead: tdist.pixie_walk_sharded_batched(
        shg, port["qp"], port["qw"], port["keys"], cfg, fabric, slack=4.0,
        shard_dead_at=dead)
    healthy, never = run(None), run(torch.full((2,), NEVER, dtype=torch.int32))
    assert healthy.killed is None and int(never.killed) == 0
    for a, b in zip(healthy[:6], never[:6]):
        _eq(a, b)


def test_one_shard_matches_reference_one_device_mesh(port):
    """S = 1 in-process against the reference's 1-device mesh."""
    sg = small_test_graph(0)
    cfg = dict(ENGINE_CFG)
    jshg = jdist.shard_graph(sg.graph, 1)
    mesh = make_mesh_compat((1,), ("model",))
    qp, qw = jnp.asarray(port["qp"].numpy()), jnp.asarray(port["qw"].numpy())
    with set_mesh_compat(mesh):
        want = jax.jit(lambda ks: jdist.pixie_walk_sharded_batched(
            jshg, qp, qw, ks, jwalk.WalkConfig(**cfg), mesh, slack=2.0))(
            jax.random.split(jax.random.key(7), 2))
    got = tdist.pixie_walk_sharded_batched(
        tdist.shard_graph(port["graph"], 1), port["qp"], port["qw"],
        port["keys"], twalk.WalkConfig(backend="pallas", **cfg),
        tdist.LocalFabric(1, device=CPU), slack=2.0)
    for name in ("counts", "board_counts", "steps_taken", "n_high",
                 "dropped", "max_occupancy"):
        _eq(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_serve_batch_matches_reference(reference, port, case):
    slack, dead = SERVE_CASES[case]
    shg = tdist.shard_graph(port["graph"], 2)
    got = tservice.serve_batch(
        shg, port["qp"], port["qw"], torch.zeros(2, dtype=torch.int32),
        prng.key(11, CPU), twalk.WalkConfig(backend="pallas", **SERVE_CFG),
        with_stats=True, fabric=tdist.LocalFabric(2, device=CPU),
        slack=slack,
        shard_dead_at=None if dead is None else torch.tensor(dead))
    want = reference[f"serve/{case}"]
    # the reference's five values, with a fault schedule or without one
    assert len(got) == 5
    if dead is not None:
        # the kill tally lives behind the port-only return_killed flag
        with_killed = tservice.serve_batch(
            shg, port["qp"], port["qw"], torch.zeros(2, dtype=torch.int32),
            prng.key(11, CPU), twalk.WalkConfig(backend="pallas", **SERVE_CFG),
            with_stats=True, fabric=tdist.LocalFabric(2, device=CPU),
            slack=slack, shard_dead_at=torch.tensor(dead), return_killed=True)
        assert len(with_killed) == 6 and int(with_killed[5]) > 0
        for a, b in zip(with_killed[:5], got):
            _eq(a, b)
    for name, a, b in zip(("scores", "ids", "steps", "n_high", "dropped"),
                          got, want):
        _eq(a, np.asarray(b, np.float32 if name == "scores" else np.int32),
            name)
    if case == "roomy":
        plain = tservice.serve_batch(
            port["graph"], port["qp"], port["qw"],
            torch.zeros(2, dtype=torch.int32), prng.key(11, CPU),
            twalk.WalkConfig(**SERVE_CFG), with_stats=True)
        assert int(got[4]) == 0
        for a, b in zip(got[:4], plain):
            _eq(a, b)
    if case == "starved":
        assert int(got[4]) > 0


def test_recommend_sharded_batched_matches_reference(reference, port):
    got = tdist.recommend_sharded_batched(
        tdist.shard_graph(port["graph"], 2), port["qp"], port["qw"],
        port["keys"], twalk.WalkConfig(**SERVE_CFG),
        tdist.LocalFabric(2, device=CPU), slack=0.05,
        shard_dead_at=torch.tensor([2, NEVER], dtype=torch.int32))
    want = reference["recommend/starved_dead"]
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        _eq(a, np.asarray(b, a.numpy().dtype))
    # the kill tally lives behind the port-only return_killed flag
    with_killed = tdist.recommend_sharded_batched(
        tdist.shard_graph(port["graph"], 2), port["qp"], port["qw"],
        port["keys"], twalk.WalkConfig(**SERVE_CFG),
        tdist.LocalFabric(2, device=CPU), slack=0.05,
        shard_dead_at=torch.tensor([2, NEVER], dtype=torch.int32),
        return_killed=True)
    assert len(with_killed) == 6 and int(with_killed[5]) > 0
    for a, b in zip(with_killed[:5], got):
        _eq(a, b)


def test_sharded_serve_batch_unpacks_like_the_reference(reference, port):
    """The reference's callers unpack five values from a dead-shard
    serve_batch; the port's must unpack the same way."""
    s, i, st, nh, d = tservice.serve_batch(
        tdist.shard_graph(port["graph"], 2), port["qp"], port["qw"],
        torch.zeros(2, dtype=torch.int32), prng.key(11, CPU),
        twalk.WalkConfig(backend="pallas", **SERVE_CFG), with_stats=True,
        fabric=tdist.LocalFabric(2, device=CPU), slack=SERVE_CASES["dead"][0],
        shard_dead_at=torch.tensor(SERVE_CASES["dead"][1]))
    want = reference["serve/dead"]
    for name, a, b in zip(("scores", "ids", "steps", "n_high", "dropped"),
                          (s, i, st, nh, d), want):
        _eq(a, np.asarray(b, np.float32 if name == "scores" else np.int32),
            name)


@pytest.mark.parametrize("case", list(RECIPE_CASES))
def test_pixie_walk_sharded_matches_reference(reference, port, case):
    wcfg = tdist.ShardedWalkConfig(slack=RECIPE_CASES[case], backend="pallas",
                                   **RECIPE)
    got = tdist.pixie_walk_sharded(
        tdist.shard_graph(port["graph"], 2), port["qp"][0], port["qw"][0],
        prng.key(3, CPU), wcfg, tdist.LocalFabric(2, device=CPU))
    scores, pins, dropped = reference[f"recipe/{case}"]
    _eq(got.top_scores, np.asarray(scores, np.float32))
    _eq(got.top_pins, pins)
    _eq(got.dropped, dropped)
    assert (int(got.dropped) > 0) == (case == "starved")


def test_sharded_config_is_the_reference_recipe():
    from repro.configs.pixie import FULL, PIXIE_SHAPES
    from repro_torch.configs import pixie as tpixie

    # every field but the backend: the port's recipe runs the hand kernel
    assert tpixie.SHARDED_WALK.backend == "pallas"
    assert dataclasses.asdict(dataclasses.replace(
        tpixie.SHARDED_WALK, backend=FULL.sharded_walk.backend)) == (
        dataclasses.asdict(FULL.sharded_walk))
    shape = {s.name: s for s in PIXIE_SHAPES}["serve_3b_sharded"].params
    port = tpixie.SERVE_3B_SHARDED
    assert (port.n_pins, port.n_boards, port.n_edges, port.n_slots) == (
        shape["n_pins"], shape["n_boards"], shape["n_edges"], FULL.n_slots)
    assert port.n_shards == 16


def test_sharded_walk_config_refuses_unroll():
    """``unroll`` was refused until the port had a dry run; it is the
    reference's XLA unrolling knob, now accepted as
    ``pixie_walk_events_fixed`` accepts its own: a config with it differs
    from one without it in that field only (its bits:
    ``test_torch_cells.py::test_sharded_walk_unroll_changes_no_bit``)."""
    cfg = tdist.ShardedWalkConfig(unroll=True)
    assert cfg.unroll and not tdist.ShardedWalkConfig().unroll
    assert dataclasses.replace(cfg, unroll=False) == tdist.ShardedWalkConfig()


def test_sharded_serve_batch_refusals(port):
    shg = tdist.shard_graph(port["graph"], 2)
    cfg = twalk.WalkConfig(**SERVE_CFG)
    args = (port["qp"], port["qw"], torch.zeros(2, dtype=torch.int32),
            prng.key(0, CPU), cfg)
    fabric = tdist.LocalFabric(2, device=CPU)
    with pytest.raises(ValueError, match="step_budgets"):
        tservice.serve_batch(shg, *args, fabric=fabric,
                             step_budgets=torch.tensor([10, 10]))
    with pytest.raises(ValueError, match="rank"):
        tservice.serve_batch(shg, *args, fabric=fabric, rank=object())
    with pytest.raises(ValueError, match="fabric"):
        tservice.serve_batch(shg, *args)
    with pytest.raises(ValueError, match="ShardedGraph"):
        tservice.serve_batch(port["graph"], *args,
                             shard_dead_at=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="bias_beta"):
        tservice.serve_batch(shg, *args[:4], dataclasses.replace(
            cfg, bias_beta=0.9), fabric=fabric)
    with pytest.raises(ValueError, match="fabric has 4"):
        tservice.serve_batch(shg, *args,
                             fabric=tdist.LocalFabric(4, device=CPU))
    with pytest.raises(ValueError, match="shard_dead_at must be"):
        tservice.serve_batch(shg, *args, fabric=fabric,
                             shard_dead_at=torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the sharded replica
# ---------------------------------------------------------------------------


def _server(port, **kw):
    return PixieServer(
        tdist.shard_graph(port["graph"], 2),
        twalk.WalkConfig(backend="pallas", **SERVER_CFG), seed=5,
        fabric=tdist.LocalFabric(2, device=CPU), slack=4.0, **kw)


def test_sharded_server_kill_revive_matches_reference(reference, port):
    srv = _server(port, batch_size=2, n_slots=4)

    def serve_round():
        for rid, (p, w) in enumerate(port["reqs"]):
            srv.submit(p, w, req_id=rid, now=0.0)
        return srv.flush(now=0.0)

    want = reference["server"]
    healthy = serve_round()
    assert srv.stats.killed == 0 and srv.dead_shards() == []
    srv.kill_shard(1, at_superstep=2)
    assert srv.dead_shards() == want["dead_shards"] == [1]
    killed = serve_round()
    assert srv.stats.killed > 0
    srv.revive_shards()
    assert srv.dead_shards() == []
    revived = serve_round()
    for name, got in (("healthy", healthy), ("killed", killed),
                      ("revived", revived)):
        assert len(got) == len(want[name])
        for r, (scores, ids) in zip(got, want[name]):
            _eq(r.scores, np.asarray(scores, np.float32), name)
            _eq(r.ids, ids, name)
    for a, b in zip(healthy, revived):
        _eq(a.ids, b.ids)
    # a swap revives every shard
    srv.kill_shard(0)
    srv.swap_graph(tdist.shard_graph(port["graph"], 2))
    assert srv.dead_shards() == [] and srv.stats.graph_generation == 1


def test_sharded_server_matches_serve_batch_oracle(port):
    """The replica's dead-shard results equal serve_batch(shard_dead_at=)
    on the same keys."""
    srv = _server(port, batch_size=4, n_slots=4)
    srv.kill_shard(0, at_superstep=3)
    for rid, (p, w) in enumerate(port["reqs"]):
        srv.submit(p, w, req_id=rid, now=0.0)
    got = srv.flush(now=0.0)
    pins = np.full((4, 4), -1, np.int32)
    weights = np.zeros((4, 4), np.float32)
    for i, (p, w) in enumerate(port["reqs"]):
        pins[i, :len(p)], weights[i, :len(w)] = p, w
    server_key = prng.key(5, CPU)
    keys = torch.stack([prng.fold_in(server_key, i) for i in range(3)]
                       + [prng.fold_in(server_key, NEVER)])
    scores, ids, _, _, dropped, killed = tservice.serve_batch(
        srv.graph, torch.from_numpy(pins), torch.from_numpy(weights),
        torch.zeros(4, dtype=torch.int32), keys, srv.cfg, with_stats=True,
        fabric=srv.fabric, slack=4.0,
        shard_dead_at=torch.tensor([3, NEVER], dtype=torch.int32),
        return_killed=True)
    for i, r in enumerate(got):
        _eq(r.scores, scores[i])
        _eq(r.ids, ids[i])
    assert srv.stats.killed == int(killed) > 0
    assert srv.stats.route_dropped == int(dropped)


def test_sharded_server_refusals(port):
    shg = tdist.shard_graph(port["graph"], 2)
    cfg = twalk.WalkConfig(**SERVER_CFG)
    fabric = tdist.LocalFabric(2, device=CPU)
    with pytest.raises(ValueError, match="can't rank"):
        PixieServer(shg, cfg, fabric=fabric, ranker=object())
    with pytest.raises(ValueError, match="multi-interest"):
        PixieServer(shg, cfg, fabric=fabric,
                    pin_topics=np.zeros((port["graph"].n_pins, 4)))
    with pytest.raises(ValueError, match="elastically"):
        PixieServer(shg, cfg, fabric=fabric, resilience=ResilienceConfig())
    with pytest.raises(ValueError, match="fabric"):
        PixieServer(shg, cfg)
    srv = PixieServer(shg, cfg, fabric=fabric)
    with pytest.raises(ValueError, match="no budgets"):
        srv.submit([1], [1.0], budget=10)
    with pytest.raises(ValueError, match="out of range"):
        srv.kill_shard(2)
    with pytest.raises(ValueError, match="at_superstep"):
        srv.kill_shard(0, at_superstep=-1)


def test_open_loop_with_shard_deaths_matches_reference(reference, port):
    from repro_torch.graphs.synthetic import top_degree_pins

    reqs = ttraffic.poisson_requests(
        top_degree_pins(port["sg"], 12).astype(np.int32),
        ttraffic.OpenLoopConfig(**OPEN_LOOP))
    faults = ttraffic.sample_fault_schedule(ttraffic.ChaosConfig(
        horizon_s=reqs[-1].t_arrival, **CHAOS))
    runs = []
    for _ in range(2):
        srv = _server(port, buckets=[(2, 2), (2, 4)])
        runs.append((ttraffic.run_open_loop(srv, reqs, faults=faults), srv))
    want = reference["open_loop"]
    (rep, srv), (rep2, _) = runs
    assert [[e.shard, e.at_superstep] for e in faults.of_kind(
        "shard_death")] == want["deaths"]
    assert srv.dead_shards() == want["dead_shards"] != []
    assert srv.stats.killed > 0
    assert (rep.n_served, rep.n_dropped) == (want["served"], want["dropped"])
    assert sorted(map(str, rep.results)) == sorted(want["results"])
    for rid, r in rep.results.items():
        scores, ids, batch_seq = want["results"][str(rid)]
        _eq(r.scores, np.asarray(scores, np.float32))
        _eq(r.ids, ids)
        assert r.batch_seq == batch_seq
        _eq(rep2.results[rid].ids, r.ids)          # the replay is identical
        _eq(rep2.results[rid].scores, r.scores)


# ---------------------------------------------------------------------------
# ProcessGroupFabric over gloo
# ---------------------------------------------------------------------------

_GLOO_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from repro_torch.core import counter as C, distributed as D, prng, walk as W
from repro_torch.graphs import synthetic

rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank)
K = json.loads(sys.argv[3])
g = synthetic.small_test_graph(0, device="cpu").graph
shg = D.shard_graph(g, 2)
fabric = D.ProcessGroupFabric(device="cpu")
cfg = W.WalkConfig(backend="pallas", **K["cfg"])
keys = prng.split(prng.key(7, "cpu"), 2)
qp, qw = torch.tensor(K["qp"], dtype=torch.int32), torch.tensor(K["qw"])
res = D.pixie_walk_sharded_batched(
    shg, qp, qw, keys, cfg, fabric, slack=K["slack"],
    shard_dead_at=torch.tensor(K["dead"], dtype=torch.int32))
top = D._hierarchical_topk(res.counts, 2, 2, 4, shg.pins_per_shard, 20,
                           fabric)
out = dict(counts=fabric.all_gather(res.counts).tolist(),
           board_counts=fabric.all_gather(res.board_counts).tolist(),
           steps_taken=res.steps_taken.tolist(), n_high=res.n_high.tolist(),
           dropped=int(res.dropped), max_occupancy=int(res.max_occupancy),
           killed=int(res.killed), scores=top[0].tolist(),
           ids=top[1].tolist())
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.mark.parametrize("slack,dead", [(0.05, [NEVER, 3])])
def test_process_group_fabric_over_gloo_equals_local_fabric(
        port, tmp_path, slack, dead):
    """Two spawned gloo processes, one shard each, equal LocalFabric(2)
    in one process: counts, board counts, stats, drops, kills, top-k."""
    qp, qw, _ = _queries()
    shared = json.dumps(dict(cfg=ENGINE_CFG, qp=qp, qw=qw, slack=slack,
                             dead=dead))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    init = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_GLOO_WORKER), str(rank),
         init, shared], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env) for rank in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    shg = tdist.shard_graph(port["graph"], 2)
    fabric = tdist.LocalFabric(2, device=CPU)
    res = tdist.pixie_walk_sharded_batched(
        shg, port["qp"], port["qw"], port["keys"],
        twalk.WalkConfig(backend="pallas", **ENGINE_CFG), fabric, slack=slack,
        shard_dead_at=torch.tensor(dead, dtype=torch.int32))
    scores, ids = tdist._hierarchical_topk(res.counts, 2, 2, 4,
                                           shg.pins_per_shard, 20, fabric)
    got = outs[0]
    for name in ("counts", "board_counts", "steps_taken", "n_high",
                 "dropped", "max_occupancy", "killed"):
        _eq(getattr(res, name), got[name], name)
    _eq(scores, np.asarray(got["scores"], np.float32))
    _eq(ids, got["ids"])
    assert int(res.dropped) > 0 and int(res.killed) > 0
