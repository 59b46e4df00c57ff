"""The port's dry run (``launch/fake.py``, ``hlo_analysis.py``, ``dryrun.py``,
``roofline_report.py``) on the CPU.

  * the tally: a product counts ``2 m n k`` FLOPs under its dtype and its
    operands and result once as bytes; a gather is charged by the rows it
    reads, not the table; views and ``empty`` move nothing; an all-reduce
    of ``N`` float32 counts ``8 N`` wire bytes and an all-gather its
    output, under the mesh axes of their group, and a group of one rank
    none; the peak of live storages of a hand-reckoned program is exact
    (freed storages leave it, views and in-place results add nothing);
  * each hand kernel's fake form (``walk_bits``, ``walk_steps_fused`` in
    both modes, ``walk_hop_fused``, ``visit_counter_update_high``,
    ``decode_attention``) through its ``ops`` dispatcher gives the plain
    twin's output shapes and dtypes on the same inputs, counts one fake
    call, charges bytes, and launches nothing;
  * autograd through the cells' collectives over two gloo ranks (a
    ``file://`` store in the test's temporary directory): the
    expert-parallel MoE loss of granite SMOKE on (1, 2) and (2, 1)
    meshes, GIN with its edges split over the ranks and DLRM's
    ``lookup_sharded`` table, each rank's loss share and grads against the
    one-process form (a local mesh or the whole edges and table): equal
    within 2e-6 times max(1, magnitude), the experts and table rows a rank
    does not own zero;
  * the mixed-dtype expert product's backward (``moe._MixedBmm``) under a
    dry run; on the card (``cuda``) against float64; granite SMOKE's loss
    and gradients in bf16 compute against the reference's ``jax.grad``, on
    the CPU and on the card (``cuda``: the reference's side stored by
    ``tests/make_moe_bf16_reference.py``, since the card's host has no
    jax), within the family's tolerance plus 16 bf16 unit roundoffs of
    each leaf's largest magnitude;
  * ``device.resolve_device`` still refuses ``cuda`` without a card, inside
    a dry run's context too; ``on_card`` is true for a fake tensor only
    inside one;
  * the H100 terms of ``hlo_analysis`` (the data sheet's rates, the link of
    an axis by whether its group fits one node);
  * FULL cells through ``run_cell`` and the CLI in one subprocess (the
    fake process group is process-global): qwen2.5-3b ``decode_32k`` and
    pixie ``serve_3b_sharded`` on the single-pod mesh, every record key
    present, the argument bytes equal to the blocks the shardings give,
    the product FLOPs and the attention kernel's equal to the model's
    own arithmetic for 8 rows a rank (the tensor-parallel program: the
    FFN and head on a sixteenth of 'mlp' and 'vocab', attention over a
    sixteenth of the sequence), the kernels' fake calls counted by the
    program's loops, and ``roofline_report``'s row of each; deepseek-moe-16b
    ``decode_32k`` and ``long_500k`` under 80 GB a rank.  Every decode
    cell's collectives are exactly the tensor-parallel step's: one all-
    gather of every shard's ``(o, m, l)`` a layer, the router's logits
    and the logits, and one sum of a ``(rows, d)`` activation a product
    and the lookup; no parameter leaf and no cache layer is gathered.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import abstract
from repro_torch import device as tdevice
from repro_torch.core import prng
from repro_torch.core import walk as twalk
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import walk_step as ws
from repro_torch.launch import fake
from repro_torch.launch import hlo_analysis as hla
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline_report as troof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The tally
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_product_counts_2mnk_and_its_bytes(dtype):
    m, k, n = 48, 64, 40
    with abstract.fake_tensor_mode():
        a = torch.empty(m, k, dtype=dtype)
        b = torch.empty(k, n, dtype=dtype)
        with fake.Tally() as t:
            c = a @ b
            v = c.view(n, m)          # a view moves nothing
            e = torch.empty(10**6)    # nor does an allocation
    name = str(dtype).replace("torch.", "")
    assert t.flops == {name: 2 * m * n * k}
    assert t.hbm_bytes == (m * k + k * n + m * n) * a.element_size()
    assert v.shape == (n, m) and e.shape == (10**6,)


def test_gather_is_charged_by_its_rows():
    rows, d, n = 1_000_000, 64, 100
    with abstract.fake_tensor_mode():
        table = torch.empty(rows, d)
        idx = torch.empty(n, dtype=torch.int64)
        with fake.Tally() as t:
            out = table[idx]
            sel = torch.index_select(table, 0, idx)
    assert out.shape == sel.shape == (n, d)
    # each: the indices read, the rows read and written once; never the table
    assert t.hbm_bytes == 2 * (8 * n + 2 * 4 * n * d)
    assert t.bytes_by_op == {"index": 8 * n + 8 * n * d, "index_select": 8 * n + 8 * n * d}


def test_in_place_scatter_is_charged_by_the_rows_it_touches():
    rows, d, n = 1_000_000, 16, 50
    with abstract.fake_tensor_mode():
        buf = torch.empty(rows, d)
        idx = torch.empty(n, dtype=torch.int64)
        src = torch.empty(n, d)
        with fake.Tally() as t:
            buf.index_add_(0, idx, src)
    assert t.hbm_bytes == 8 * n + 3 * 4 * n * d


def test_peak_of_a_hand_reckoned_program_is_exact():
    n = 1000                                      # 4,000 bytes a tensor
    with abstract.fake_tensor_mode():
        a = torch.empty(n)
        tally = fake.Tally()
        tally.track({"a": a})
        with tally:
            b = a * 2                              # a, b: 8,000
            c = b + 1                              # a, b, c: 12,000
            del b                                  # a, c: 8,000
            d = torch.cat([c, c])                  # a, c, d: 16,000
            del c                                  # a, d: 12,000
            e = d[:n] * 3                          # a, d, e: 16,000
            d.view(-1).add_(1)                     # in place, a view: no new storage
            del d                                  # a, e: 8,000
            f = e.clone()                          # a, e, f: 12,000
    assert tally.peak_bytes == 16_000
    assert tally.live_bytes == 12_000 and f.shape == (n,)


def test_collectives_count_wire_bytes_by_kind_and_axis(tmp_path):
    """A fake process group of 8 ranks, (2, 4) mesh, in a process of its own."""
    body = """
        import json
        import torch
        import torch.distributed as dist
        from repro_torch import abstract
        from repro_torch.launch import cells, fake
        from repro_torch.launch.mesh import process_group_mesh
        fake.start_fake_world(8)
        mesh = process_group_mesh((2, 4), ("data", "model"), device="cpu")
        axis_of = cells.axis_groups(mesh)
        n = 1000
        alone = dist.new_group([0])
        with abstract.fake_tensor_mode():
            x = torch.empty(n)
            with fake.Tally(axis_of) as t:
                dist.all_reduce(x, group=mesh.device_mesh.get_group("model"))
                parts = mesh.fabric("data").all_gather(x[None])
                y = mesh.fabric(("data", "model")).psum(x[None])
                dist.all_reduce(x, group=alone)      # one rank: moves nothing
            # a functional all-gather and its wait: one output, as eagerly
            from torch.distributed.tensor import DTensor, Shard
            d = DTensor.from_local(torch.empty(n), mesh.device_mesh["model"], [Shard(0)],
                                   run_check=False)
            g = fake.Tally(axis_of)
            before = g.live_bytes
            with g:
                full = d.full_tensor()
        print(json.dumps({"coll": t.collectives, "axis": t.coll_by_axis,
                          "hbm": t.hbm_bytes, "parts": list(parts.shape),
                          "labels": sorted(axis_of.values()),
                          "gathered": [list(full.shape), g.peak_bytes - before,
                                       g.collectives["all-gather"]]}))
    """
    out = _run_port(body, tmp_path)
    n = 1000
    assert out["coll"]["all-reduce"] == 2 * (8 * n)     # two all-reduces of 4 N bytes x 2
    assert out["coll"]["all-gather"] == 2 * 4 * n       # its output: 2 ranks x 4 N bytes
    assert out["axis"] == {"model": 8 * n, "data": 8 * n, "data+model": 8 * n}
    assert out["parts"] == [2, n]
    assert out["labels"] == ["data", "data+model", "model"]
    assert out["gathered"] == [[4 * n], 4 * 4 * n, 4 * 4 * n]


# ---------------------------------------------------------------------------
# Fake forms of the hand kernels
# ---------------------------------------------------------------------------


def _small_graph():
    from repro_torch.graphs.synthetic import small_test_graph

    return small_test_graph(0, device="cpu").graph


def _walk_inputs(graph, w=64, n_queries=0):
    g = torch.Generator().manual_seed(1)
    curr = torch.randint(0, graph.n_pins, (w,), generator=g, dtype=torch.int32)
    lanes = dict(curr=curr, query=curr.clone(), feat=torch.zeros(w, dtype=torch.int32),
                 slot=torch.randint(0, 4, (w,), generator=g, dtype=torch.int32))
    if n_queries:
        lanes["qid"] = torch.arange(w, dtype=torch.int32) // (w // n_queries)
        keys = prng.split(prng.key(7, "cpu"), n_queries)
    else:
        keys = prng.key(7, "cpu")
    return lanes, keys


def _as_fake(mode, tree_):
    return [None if x is None else mode.from_tensor(x) for x in tree_]


def _calls(kernel_name, run_plain, run_kernel):
    """The plain route on real tensors, then the kernel route on fake
    copies under a dry run: ``(plain outputs, fake outputs, tally)``."""
    plain = run_plain()
    before = dict(_build.launches)
    mode = abstract.fake_tensor_mode()
    with mode, abstract.reckon_card(), fake.Tally() as t:
        got = run_kernel(lambda *xs: _as_fake(mode, xs))
    assert _build.launches == before, "a fake form launched"
    assert t.kernels == {kernel_name: 1} and t.bytes_by_op[kernel_name] > 0
    return plain, got, t


def _same_shapes(plain, got):
    plain = plain if isinstance(plain, tuple) else (plain,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(plain) == len(got)
    for p, g in zip(plain, got):
        assert (p is None) == (g is None)
        if p is not None:
            assert abstract.is_fake(g)
            assert (tuple(g.shape), g.dtype) == (tuple(p.shape), p.dtype)


@pytest.mark.parametrize("n_queries", [0, 4])
def test_walk_kernels_fake_forms_give_the_twins_shapes(n_queries):
    graph = _small_graph()
    lanes, keys = _walk_inputs(graph, n_queries=n_queries)
    csr = (graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets, graph.b2p.targets)
    kw = dict(step_base=8, chunk_steps=4, n_pins=graph.n_pins, n_slots=4,
              n_boards=graph.n_boards, alpha_u32=twalk._prob_u32(0.5), beta_u32=0,
              count_boards=True)
    if n_queries:
        fn = lambda conv, use: ops.walk_chunk_fused_batched(
            *conv(lanes["curr"], lanes["query"], lanes["feat"], lanes["slot"],
                  lanes["qid"], keys, *csr), n_queries=n_queries, use_kernel=use, **kw)
    else:
        fn = lambda conv, use: ops.walk_chunk_fused(
            *conv(lanes["curr"], lanes["query"], lanes["feat"], lanes["slot"], keys, *csr),
            use_kernel=use, **kw)
    plain, got, t = _calls("walk_steps_fused", lambda: fn(lambda *x: x, True),
                           lambda conv: fn(conv, True))
    _same_shapes(plain, got)
    w, c = lanes["curr"].shape[0], kw["chunk_steps"]
    n_keys = max(n_queries, 1)
    lanes_out = 4 if n_queries else 3
    assert t.flops == {"int32": ws.threefry_ops(n_keys, w, c)}
    assert t.bytes_by_op["walk_steps_fused"] == (
        4 * (5 if n_queries else 4) * w + 4 * w + 8 * n_keys
        + 4 * lanes_out * c * w + ws.SECTOR * 4 * c * w)


def test_walk_bits_and_hop_fake_forms_give_the_twins_shapes():
    keys = prng.split(prng.key(3, "cpu"), 2)
    plain, got, t = _calls(
        "walk_bits", lambda: ops.walk_bits(keys, 0, 8, 16, use_kernel=True),
        lambda conv: ops.walk_bits(*conv(keys), 0, 8, 16, use_kernel=True))
    _same_shapes(plain, got)
    assert t.flops == {"int32": ws.threefry_ops(2, 32, 8)}

    from repro_torch.core import distributed as tdist

    shg = tdist.shard_graph(_small_graph(), 2)
    table = twalk._chunk_rbits(prng.key(1, "cpu"), 0, 8, 40)
    g = torch.Generator().manual_seed(2)
    pos = torch.randint(0, shg.pins_per_shard, (2, 20), generator=g, dtype=torch.int32)
    pos[1] += shg.pins_per_shard
    gate = torch.rand(2, 20, generator=g) < 0.7
    walker = torch.randint(0, 40, (2, 20), generator=g, dtype=torch.int32)
    base = torch.tensor([0, shg.pins_per_shard], dtype=torch.int32)
    args = (pos, gate, table, shg.p2b_offsets, shg.p2b_targets, base, walker)

    def hop(xs):
        p, ga, tb, off, tg, b, wk = xs
        return ops.walk_hop(p, ga, tb, off, tg, b, step=3, column=2, walker=wk,
                            use_kernel=True)

    plain, got, t = _calls("walk_hop_fused", lambda: hop(args),
                           lambda conv: hop(conv(*args)))
    _same_shapes(plain, got)
    assert t.bytes_by_op["walk_hop_fused"] == 40 * 14 + 4 * 2 + ws.SECTOR * 3 * 40


def test_counter_and_attention_fake_forms_give_the_twins_shapes():
    g = torch.Generator().manual_seed(4)
    n_slots, n_pins, m = 4, 300, 500
    sev = torch.randint(0, n_slots + 1, (m,), generator=g, dtype=torch.int32)
    pev = torch.randint(0, n_pins, (m,), generator=g, dtype=torch.int32)
    counts = torch.zeros(n_slots * n_pins, dtype=torch.int32)
    high = torch.zeros(n_slots, dtype=torch.int32)

    def upd(xs):
        c, s, p, h = xs
        return ops.visit_counts_update_high(c, s, p, n_slots=n_slots, n_pins=n_pins,
                                            n_v=2, high=h, use_kernel=True)

    plain, got, t = _calls("visit_counter_update_high",
                           lambda: upd((counts.clone(), sev, pev, high.clone())),
                           lambda conv: upd(conv(counts, sev, pev, high)))
    _same_shapes(plain, got)
    assert t.bytes_by_op["visit_counter_update_high"] == 4 * 2 * m + 2 * 32 * m + 8 * n_slots

    b, h, kh, dh, s = 3, 8, 2, 16, 40
    q = torch.randn(b, h, dh, generator=g)
    k = torch.randn(b, s, kh, dh, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, kh, dh, generator=g).to(torch.bfloat16)
    att = lambda xs: ops.decode_attention(*xs, 33, use_kernel=True)
    plain, got, t = _calls("decode_attention", lambda: att((q, k, v)),
                           lambda conv: att(conv(q, k, v)))
    _same_shapes(plain, got)
    assert t.flops == {"float32": 4 * h * dh * 33 * b}
    assert t.bytes_by_op["decode_attention"] == (4 * b * h * dh * 2
                                                 + 2 * b * 33 * kh * dh * 2)


# ---------------------------------------------------------------------------
# The device rule and the data-sheet terms
# ---------------------------------------------------------------------------


def test_resolve_device_still_refuses_cuda_outside_and_inside_a_dry_run():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: cuda resolves")
    for ctx in (abstract.reckon_card, lambda: abstract.fake_tensor_mode()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdevice.resolve_device()
        with ctx():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_on_card_reads_fake_tensors_only_inside_a_dry_run():
    real = torch.zeros(3)
    mode = abstract.fake_tensor_mode()
    with mode:
        f = torch.zeros(3)
        assert not tdevice.on_card(f) and not tdevice.on_card(real)
        with abstract.reckon_card():
            assert tdevice.on_card(f) and not tdevice.on_card(real)
        assert not tdevice.on_card(f)


def test_h100_terms_and_link_rates():
    assert (hla.BF16_PEAK_FLOPS, hla.FP32_PEAK_FLOPS, hla.HBM_BW) == (989.4e12, 66.9e12,
                                                                      3.35e12)
    assert (hla.NVLINK_BW, hla.NDR_BW) == (450e9, 50e9)
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    node = tmesh.Mesh((2, 4), ("data", "model"), kind="abstract")
    assert hla.axis_bandwidth(single, "model") == hla.NDR_BW       # 16 ranks: 2 nodes
    assert hla.axis_bandwidth(multi, ("pod", "data")) == hla.NDR_BW
    assert hla.axis_bandwidth(node, "model") == hla.NVLINK_BW      # 4 ranks in a node
    assert hla.axis_bandwidth(node, ("data", "model")) == hla.NVLINK_BW
    r = hla.RooflineTerms(flops=3e12, hbm_bytes=3.35e12, coll_bytes_per_dev=0.0, n_chips=1,
                          flops_by_dtype={"bfloat16": 989.4e12, "float32": 66.9e12},
                          coll_seconds_by_axis={"model": 0.5})
    assert (r.t_compute, r.t_memory, r.t_collective) == (2.0, 1.0, 0.5)
    assert r.dominant == "compute" and r.step_time_lower_bound == 2.0
    assert set(r.as_dict()) >= {"flops", "hbm_bytes", "coll_bytes_per_dev", "n_chips",
                                "bytes_per_device", "t_compute_s", "t_memory_s",
                                "t_collective_s", "dominant"}


# ---------------------------------------------------------------------------
# Two FULL cells through run_cell and the CLI
# ---------------------------------------------------------------------------


def _run_port(body: str, tmp_path) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(body)], capture_output=True,
                         text=True, env=env, timeout=400, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def full_cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    body = """
        import json, math
        from repro_torch.configs import get_arch
        from repro_torch.kernels import _build
        from repro_torch.launch import cells, dryrun, mesh
        from repro_torch.training import tree

        rec = dryrun.run_cell("qwen2.5-3b", "decode_32k", "single")
        deep = {s: dryrun.run_cell("deepseek-moe-16b", s, "single")
                for s in ("decode_32k", "long_500k")}
        assert dryrun.main(["--arch", "pixie", "--shape", "serve_3b_sharded",
                            "--mesh", "single", "--out", "dry.jsonl"]) == 0
        pix = json.loads(open("dry.jsonl").read().splitlines()[-1])
        # the blocks the shardings give, from the cell's own shardings
        spec = get_arch("qwen2.5-3b")
        cell = cells.build_cell(spec, spec.shapes[2], mesh.make_production_mesh())
        blocks = 0
        for a, s in zip(cell.args, cell.in_shardings):
            for x, sh in zip(tree.leaves(a), tree.leaves(s)):
                blocks += x.numel() * x.element_size() // math.prod(
                    sh.shards(d) for d in range(x.dim()))
        print(json.dumps({"qwen": rec, "pixie": pix, "blocks": blocks, "deepseek": deep,
                          "launches": sum(_build.launches.values())}))
    """
    out = _run_port(body, tmp)
    out["jsonl"] = str(tmp / "dry.jsonl")
    return out


KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "status", "form", "memory_analysis",
        "collectives", "coll_by_axis", "kernels", "flops", "flops_by_dtype", "hbm_bytes",
        "coll_bytes_per_dev", "bytes_per_device", "t_compute_s", "t_memory_s",
        "t_collective_s", "dominant", "seconds"}


def test_full_qwen_decode_cell_reckons_its_blocks_and_products(full_cells):
    from repro_torch.configs import get_arch

    rec = full_cells["qwen"]
    assert rec["status"] == "ok" and KEYS <= set(rec) and full_cells["launches"] == 0
    assert (rec["n_chips"], rec["kind"], rec["form"]) == (256, "decode", "real")
    assert rec["memory_analysis"]["argument_size"] == full_cells["blocks"]
    cfg = get_arch("qwen2.5-3b").config
    d, hp, dh, kh, ff, v = (cfg.d_model, cfg.n_heads_padded, cfg.head_dim, cfg.n_kv_heads,
                            cfg.d_ff, cfg.vocab_padded)
    rows, seq, n = 128 // 16, 32768, 16
    # the heads whole (serve rules), the FFN on a sixteenth of 'mlp', the
    # head on a sixteenth of 'vocab'
    matmul = cfg.n_layers * (2 * d * hp * dh + 2 * d * kh * dh + 3 * d * ff // n) + v * d // n
    assert rec["flops_by_dtype"]["bfloat16"] == 2 * rows * matmul
    # attention over this rank's kv_seq block
    assert rec["flops_by_dtype"]["float32"] == (4 * cfg.n_heads * dh * (seq // n) * rows
                                                * cfg.n_layers)
    assert rec["kernels"] == {"decode_attention_partial": cfg.n_layers}
    _only_step_collectives(rec, cfg, rows, n)
    ma = rec["memory_analysis"]
    assert rec["bytes_per_device"] == ma["argument_size"] + ma["temp_size"]
    assert rec["t_collective_s"] == rec["coll_bytes_per_dev"] / 50e9


def _only_step_collectives(rec, cfg, rows, n):
    """The decode step's collectives, exactly: per layer one all-gather of
    every shard's ``(o, m, l)`` (float32, ``dh + 2`` a head) and, for a MoE
    block, of the router's logits; the logits' all-gather; one sum of the
    ``(rows, d)`` activation (compute dtype, counted twice on the wire) per
    FFN (a MoE block's routed and shared partials in the same sum) and for
    the lookup.  No parameter leaf or cache layer is gathered."""
    d, dh, nh = cfg.d_model, cfg.head_dim, cfg.n_heads
    n_moe = cfg.n_scan if cfg.moe is not None else 0
    experts = cfg.moe.n_experts_padded if n_moe else 0
    gather = 4 * rows * (cfg.n_layers * n * nh * (dh + 2) + cfg.vocab_padded
                         + n_moe * experts)
    sums = 1 + cfg.n_layers
    assert set(rec["coll_by_axis"]) == {"model"}
    assert rec["collectives"]["all-gather"] == gather
    assert rec["collectives"]["all-reduce"] == 2 * sums * rows * d * 2      # bf16


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_full_deepseek_decode_cells_fit_a_rank_and_gather_no_leaf(full_cells, shape):
    from repro_torch.configs import get_arch

    rec = full_cells["deepseek"][shape]
    n_moe = get_arch("deepseek-moe-16b").config.n_scan     # one router top-k each
    assert rec["status"] == "ok" and rec["kernels"] == {"decode_attention_partial": 28,
                                                        "topk_select": n_moe}
    ma = rec["memory_analysis"]
    assert (ma["argument_size"] + ma["temp_size"]) / 1e9 < 80.0
    rows = 128 // 16 if shape == "decode_32k" else 1
    _only_step_collectives(rec, get_arch("deepseek-moe-16b").config, rows, 16)
    assert rec["t_collective_s"] < rec["t_memory_s"]


def test_full_pixie_sharded_cell_counts_its_kernels(full_cells):
    rec = full_cells["pixie"]
    assert rec["status"] == "ok" and KEYS <= set(rec)
    sw = 24                          # supersteps of the production recipe, 8 a chunk
    # the top-k's selection twice: the rank's shard, then the gathered candidates
    assert rec["kernels"] == {"walk_bits": sw // 8, "walk_hop_fused": 2 * sw,
                              "visit_counter_update_high": sw, "topk_select": 2}
    assert rec["flops_by_dtype"]["int32"] > 0
    assert rec["collectives"]["all-to-all"] > 0 and set(rec["coll_by_axis"]) == {"model"}
    # one shard's CSR a rank: its offsets and 25%-headroom target slices
    pps, bps = 2_000_000_000 // 16, 1_000_000_000 // 16
    eps = int(17_000_000_000 // 16 * 1.25)
    graph = 4 * ((pps + 1) + (bps + 1) + 2 * eps)
    assert graph < rec["memory_analysis"]["argument_size"] < graph + 1000


def test_roofline_report_rows(full_cells):
    cells = troof.load_latest(full_cells["jsonl"])
    row = troof.fmt_row(cells[("pixie", "serve_3b_sharded", "single")])
    assert row.startswith("| pixie/serve_3b_sharded | single |") and row.endswith("|  |")
    qwen = dict(full_cells["qwen"])
    mf = troof.model_flops("qwen2.5-3b", "decode_32k", "decode")
    ratio = mf / 256 / qwen["flops"]
    assert troof.fmt_row(qwen).endswith(f"| {ratio:.2f} |") and 0 < ratio < 1


@pytest.fixture(scope="module")
def smoke_train_cells(tmp_path_factory):
    """The LM train cell at SMOKE widths traced on a fake (2, 4) world:
    qwen2.5-3b (dense) and granite with ``ep_shard_map`` (MoE), 2
    microbatches of 2 rows a rank, seq 16; each record, the shapes of the
    step's gradients (``microbatch.accumulated_grads`` spied on) and the
    state's blocks and whole shapes from the cell's shardings."""
    tmp = tmp_path_factory.mktemp("dryrun_train")
    body = """
        import dataclasses, json
        from repro_torch.configs import get_arch
        from repro_torch.launch import cells, dryrun, mesh
        from repro_torch.training import microbatch, tree

        grads = []
        accumulated = microbatch.accumulated_grads

        def spy(loss_fn, params, batch, n_micro):
            loss, g = accumulated(loss_fn, params, batch, n_micro)
            grads.append([list(x.shape) for x in tree.leaves(g)])
            return loss, g

        microbatch.accumulated_grads = spy
        shape = {"seq_len": 16, "global_batch": 8}
        out = {}
        for name, arch, moe in (("qwen", "qwen2.5-3b", None),
                                ("granite", "granite-moe-3b-a800m", {"ep_shard_map": True})):
            spec = get_arch(arch)
            cfg = spec.smoke_config
            if moe:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
            grads.clear()
            rec = dryrun.run_cell(arch, "train_4k", "small", n_micro=2, params=shape,
                                  config=cfg)
            cell_spec = next(c for c in spec.shapes if c.name == "train_4k")
            cell_spec = dataclasses.replace(cell_spec, params={**cell_spec.params, **shape})
            abstract = mesh.Mesh((2, 4), ("data", "model"), kind="abstract")
            c = cells.build_cell(dataclasses.replace(spec, config=cfg), cell_spec, abstract,
                                 n_micro=2)
            (params, opt), batch = c.args
            (psh, osh), _ = c.in_shardings
            blocks = lambda t, sh: [[n // s.shards(d) for d, n in enumerate(x.shape)]
                                    for x, s in zip(tree.leaves(t), tree.leaves(sh))]
            out[name] = {"rec": rec, "grads": grads[-1], "n_grad_calls": len(grads),
                         "param_blocks": blocks(params, psh),
                         "state_blocks": blocks((params, opt), (psh, osh)),
                         "whole": [list(x.shape) for x in tree.leaves(params)],
                         "split": [any(p == "model" for p in s.spec)
                                   for s in tree.leaves(psh)],
                         "batch_bytes": sum(x.numel() * x.element_size()
                                            for x in tree.leaves(batch)),
                         "n_moe": cfg.n_scan if cfg.moe else 0,
                         "e_pad": cfg.moe.n_experts_padded if cfg.moe else 0}
        print(json.dumps(out))
    """
    return _run_port(body, tmp)


@pytest.mark.parametrize("name", ["qwen", "granite"])
def test_smoke_train_cell_holds_blocks_and_gathers_no_leaf_over_model(smoke_train_cells,
                                                                      name):
    """The tensor-parallel train cell on a fake (2, 4) world: each
    gradient is its parameter's block (a leaf split over 'model' a quarter
    of its whole, and of its 'data' dims a half), so the per-rank
    parameter and gradient bytes fall by the 'model' size on those leaves;
    the argument bytes are the state's blocks and the whole batch; the
    all-gathers over 'model' carry only the MoE router's logits ``(4 t,
    E_pad / 4)`` float32 (none in a dense model), and the FSDP gradients
    come back reduce-scattered over 'data'."""
    import math

    out = smoke_train_cells[name]
    rec = out["rec"]
    assert rec["status"] == "ok" and rec["kind"] == "train" and rec["n_chips"] == 8
    assert out["n_grad_calls"] == 1
    assert out["grads"] == out["param_blocks"]
    split_whole = sum(math.prod(w) for w, s in zip(out["whole"], out["split"]) if s)
    split_grad = sum(math.prod(g) for g, s in zip(out["grads"], out["split"]) if s)
    assert split_whole // 8 <= split_grad <= split_whole // 4
    assert sum(math.prod(g) for g in out["grads"]) < sum(math.prod(w) for w in out["whole"]) / 2
    state = sum(4 * math.prod(b) for b in out["state_blocks"])   # float32, step int32
    assert rec["memory_analysis"]["argument_size"] == state + out["batch_bytes"]
    t = (8 // 2 // 2) * 16                       # a rank's tokens a microbatch
    model = rec["gathers_by_axis"].get("model", {})
    if out["n_moe"]:
        assert model == {f"({4 * t}, {out['e_pad'] // 4}) float32": 2 * out["n_moe"]}
    else:
        assert model == {}
    assert rec["collectives"]["reduce-scatter"] > 0 and rec["gathers_by_axis"]["data"]
    assert {"data", "model"} <= set(rec["coll_by_axis"])


# ---------------------------------------------------------------------------
# Autograd through the cells' collectives, two gloo ranks
# ---------------------------------------------------------------------------

_GRAD_SCRIPT = """
import dataclasses, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import dlrm_rm2, gin_tu, granite_moe_3b_a800m as G
from repro_torch.core.distributed import LocalFabric
from repro_torch.launch import mesh as M
from repro_torch.models import dlrm, embedding, gnn, transformer as tf
from repro_torch.training import tree

rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
pg = rank >= 0
if pg:
    dist.init_process_group("gloo", init_method="file://" + store, world_size=2, rank=rank)
res = {}

def grads(loss, params):
    names, leaves = tree.flatten_with_names(params)
    gs = torch.autograd.grad(loss, leaves)
    res.update({f"{tag}|loss": loss.detach().numpy()})
    res.update({f"{tag}|{n}": g.numpy() for n, g in zip(names, gs)})

def fresh(p):
    return tree.tree_map(lambda x: x.detach().clone().requires_grad_(True), p)

# the MoE LM with expert parallelism
cfg = dataclasses.replace(G.SMOKE, moe=dataclasses.replace(G.SMOKE.moe, ep_shard_map=True))
params = tf.init_params(torch.Generator().manual_seed(0), cfg)
g = torch.Generator().manual_seed(1)
toks = torch.randint(0, cfg.vocab_size, (4, 8), generator=g, dtype=torch.int32)
labs = torch.randint(0, cfg.vocab_size, (4, 8), generator=g, dtype=torch.int32)
mask = (torch.rand(4, 8, generator=g) > 0.2).float()
for shape in ((1, 2), (2, 1)):
    tag = "moe%dx%d" % shape
    if pg:
        mesh = M.process_group_mesh(shape, ("data", "model"), device="cpu")
        n = shape[0]
        rows = slice(mesh.coordinate("data") * 4 // n, (mesh.coordinate("data") + 1) * 4 // n)
        p = fresh(params)
        loss = tf.loss_fn(p, toks[rows], labs[rows], mask[rows], cfg, mesh=mesh)
    else:
        mesh = M.local_mesh(shape, ("data", "model"), device="cpu")
        p = fresh(params)
        loss = tf.loss_fn(p, toks, labs, mask, cfg, mesh=mesh)
    grads(loss, p)

# GIN with its edges split over the ranks
gcfg = dataclasses.replace(gin_tu.SMOKE, readout=None)
gp = gnn.init_params(torch.Generator().manual_seed(2), gcfg)
g = torch.Generator().manual_seed(3)
n_nodes, n_edges = 50, 200
feats = torch.randn(n_nodes, gcfg.d_in, generator=g)
src = torch.randint(0, n_nodes, (n_edges,), generator=g, dtype=torch.int32)
dst = torch.randint(0, n_nodes, (n_edges,), generator=g, dtype=torch.int32)
labels = torch.randint(0, gcfg.n_classes, (n_nodes,), generator=g, dtype=torch.int32)
nmask = torch.ones(n_nodes)
tag, p = "gin", fresh(gp)
if pg:
    fab = M.process_group_mesh((1, 2), ("data", "model"), device="cpu").fabric("model")
    half = slice(rank * n_edges // 2, (rank + 1) * n_edges // 2)
    loss = gnn.node_classification_loss(p, feats, src[half], dst[half], labels, nmask, gcfg,
                                        edge_fabric=fab)
else:
    loss = gnn.node_classification_loss(p, feats, src, dst, labels, nmask, gcfg)
grads(loss, p)

# DLRM's mega-table lookup over the 'model' shards
dcfg = dlrm_rm2.SMOKE
table = embedding.init_table(torch.Generator().manual_seed(4), dcfg.table)
ids = torch.randint(0, 64, (6, dcfg.n_sparse), generator=torch.Generator().manual_seed(5),
                    dtype=torch.int32)
w = torch.randn(6, dcfg.n_sparse, dcfg.embed_dim, generator=torch.Generator().manual_seed(6))
tag = "dlrm"
if pg:
    fab = M.process_group_mesh((1, 2), ("data", "model"), device="cpu").fabric("model")
    r = dcfg.table.total_rows // 2
    t = table[rank * r:(rank + 1) * r].clone().requires_grad_(True)
    loss = (embedding.lookup_sharded(t, ids, dcfg.table, fab) * w).sum()
else:
    t = table.clone().requires_grad_(True)
    loss = (embedding.lookup(t, ids, dcfg.table) * w).sum()
grads(loss, {"table": t})
np.savez(out, **res)
if pg:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def grad_runs(tmp_path_factory):
    """The gloo ranks and the one-process form, each its own process."""
    tmp = tmp_path_factory.mktemp("grads")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    script = textwrap.dedent(_GRAD_SCRIPT)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(tmp / "store"),
                               str(tmp / f"r{r}.npz")], env=env, stderr=subprocess.PIPE,
                              text=True) for r in (-1, 0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    load = lambda r: dict(np.load(tmp / f"r{r}.npz"))
    return load(-1), load(0), load(1)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
    assert err <= 2e-6 * scale, f"{what}: {err}"


def _split(one, ranks, tag):
    keys = sorted(k for k in one if k.startswith(tag + "|"))
    assert keys and all(sorted(k for k in r if k.startswith(tag + "|")) == keys for r in ranks)
    return keys


def test_ep_moe_grads_over_model_ranks_equal_the_local_form(grad_runs):
    """(1, 2): each rank the whole loss; its grads the local form's on every
    leaf it computes in full, and on its own experts' block; zero on the
    other rank's experts."""
    one, r0, r1 = grad_runs
    for k in _split(one, (r0, r1), "moe1x2"):
        want = one[k]
        for rank, got in enumerate((r0[k], r1[k])):
            if "['moe']" in k and "router" not in k:
                e = want.shape[1] // 2
                mine = slice(rank * e, (rank + 1) * e)
                _close(got[:, mine], want[:, mine], f"{k} rank {rank}")
                assert not got[:, slice((1 - rank) * e, (2 - rank) * e)].any(), k
            else:
                _close(got, want, f"{k} rank {rank}")


def test_ep_moe_grads_over_data_ranks_sum_to_the_local_form(grad_runs):
    """(2, 1): each rank its share of the loss over its rows; the shares and
    their grads add up to the local form's."""
    one, r0, r1 = grad_runs
    for k in _split(one, (r0, r1), "moe2x1"):
        _close(r0[k] + r1[k], one[k], k)


def test_gin_and_dlrm_grads_over_ranks_equal_the_whole(grad_runs):
    one, r0, r1 = grad_runs
    for k in _split(one, (r0, r1), "gin"):
        _close(r0[k], one[k], k)
        _close(r1[k], one[k], k)
    _close(r0["dlrm|loss"], one["dlrm|loss"], "dlrm loss")
    rows = one["dlrm|['table']"].shape[0] // 2
    _close(r0["dlrm|['table']"], one["dlrm|['table']"][:rows], "table block 0")
    _close(r1["dlrm|['table']"], one["dlrm|['table']"][rows:], "table block 1")


# ---------------------------------------------------------------------------
# The mixed-dtype expert product under autograd
# ---------------------------------------------------------------------------


def test_mixed_expert_product_backward_under_a_dry_run():
    from repro_torch.models import moe

    with abstract.fake_tensor_mode(), abstract.reckon_card(), fake.Tally() as t:
        a = torch.empty(4, 8, 16, dtype=torch.bfloat16, requires_grad=True)
        b = torch.empty(4, 16, 12, dtype=torch.bfloat16, requires_grad=True)
        y = moe.expert_matmul(a, b)
        ga, gb = torch.autograd.grad(y.sum(), (a, b))
    assert y.dtype == torch.float32 and y.shape == (4, 8, 12)
    assert (ga.dtype, gb.dtype, ga.shape, gb.shape) == (torch.bfloat16, torch.bfloat16,
                                                        a.shape, b.shape)
    # the forward on the tensor cores, the two backward products in float32
    assert t.flops == {"bfloat16": 2 * 4 * 8 * 16 * 12, "float32": 2 * 2 * 4 * 8 * 16 * 12}


@pytest.mark.cuda
def test_mixed_expert_product_backward_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(6, 32, 64, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
    b = torch.randn(6, 64, 48, generator=g, device="cuda").to(torch.bfloat16).requires_grad_()
    w = torch.randn(6, 32, 48, generator=g, device="cuda")
    y = moe.expert_matmul(a, b)
    ga, gb = torch.autograd.grad((y * w).sum(), (a, b))
    ref_a = (w.double() @ b.double().transpose(1, 2))
    ref_b = (a.double().transpose(1, 2) @ w.double())
    for got, ref in ((ga, ref_a), (gb, ref_b)):
        # float32 products rounded once to bf16: within one bf16 half-ulp and
        # the float32 product's own error
        err = (got.double() - ref).abs()
        assert bool((err <= ref.abs() * 2**-8 + 1e-4).all())
    assert torch.equal(y, torch.bmm(a, b, out_dtype=torch.float32))


@pytest.mark.cuda
def test_moe_bf16_train_step_runs_on_card():
    """A MoE step in bf16 compute on the card: the expert products take
    ``_MixedBmm``'s backward (torch gives ``bmm(out_dtype=)`` none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.models import transformer
    from repro_torch.training import optim, train_loop

    cfg = dataclasses.replace(granite_moe_3b_a800m.SMOKE, compute_dtype=torch.bfloat16)
    dev = torch.device("cuda")
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), generator=g, device=dev,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab_size, (4, 16), generator=g, device=dev,
                                     dtype=torch.int32),
             "mask": torch.ones(4, 16, device=dev)}
    step = train_loop.make_train_step(
        lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg),
        train_loop.TrainStepConfig(n_micro=2))
    (params, opt), metrics = step((params, optim.init(params)), batch)
    assert all(bool(torch.isfinite(metrics[k])) for k in ("loss", "grad_norm"))
    assert float(metrics["grad_norm"]) > 0 and int(opt.step) == 1


# ---------------------------------------------------------------------------
# The bf16 MoE loss and gradients against the reference's jax.grad
# ---------------------------------------------------------------------------

# bf16 gradients: the family's tolerance (2e-6 times max(1, m), m the
# leaf's largest reference magnitude) plus BF16_TERM times m.  On this input
# the port's and the reference's own bf16 errors against the port's float64
# evaluation reach 7.4 bf16 unit roundoffs (2**-8) of m each (the ``wv``
# leaf), so their difference may reach twice that: 16 units.  A wrong
# gradient is off by the order of m itself.
BF16_TERM = 16 * 2.0 ** -8
BF16_FILE = os.path.join(os.path.dirname(__file__), "data", "granite_smoke_bf16.npz")


def _bf16_case():
    """The stored case (``tests/make_moe_bf16_reference.py``): granite SMOKE
    in bf16 compute, its parameters and batch, and the reference's loss and
    gradients, each a dict of names to arrays."""
    d = np.load(BF16_FILE)
    params = {k.split("|", 1)[1]: d[k] for k in d.files if k.startswith("param|")}
    grads = {k.split("|", 1)[1]: d[k] for k in d.files if k.startswith("grad|")}
    batch = {k: d[k] for k in ("tokens", "labels", "mask")}
    return params, batch, float(d["loss"]), grads


def _port_bf16_loss_grads(params: dict, batch: dict, dev):
    """The port's ``transformer.loss_fn`` in bf16 compute on ``dev``: the
    loss and the gradients by name."""
    import dataclasses

    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.models import transformer
    from repro_torch.training import tree
    from repro_torch.training.microbatch import value_and_grad

    cfg = dataclasses.replace(granite_moe_3b_a800m.SMOKE, compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16)
    nested = {}
    for name, x in params.items():
        keys = [k[2:-2] for k in name.split("/")]
        node = nested
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.from_numpy(x).to(dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    loss, grads = value_and_grad(lambda p: transformer.loss_fn(
        p, b["tokens"], b["labels"], b["mask"], cfg))(nested)
    names, leaves = tree.flatten_with_names(grads)
    return float(loss), {n: g.cpu().numpy() for n, g in zip(names, leaves)}


def _bf16_close(got_loss, got, want_loss, want, what):
    assert sorted(got) == sorted(want), what
    for name, g, w in [("loss", np.float32(got_loss), np.float32(want_loss))] + [
            (n, got[n], want[n]) for n in sorted(want)]:
        assert g.shape == w.shape, f"{what} {name}"
        m = float(np.abs(w).max())
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= 2e-6 * max(1.0, m) + BF16_TERM * m, f"{what} {name}: {err} of {m}"


def test_moe_bf16_reference_file_is_the_reference():
    """The stored reference side equals a fresh reference run on the stored
    parameters and batch, which are the port's ``init_params`` (seed 0)."""
    import make_moe_bf16_reference as mk

    params, batch, loss, grads = _bf16_case()
    want_params, want_batch = mk.inputs()
    assert sorted(params) == sorted(want_params)
    for k in params:
        np.testing.assert_array_equal(params[k], want_params[k], err_msg=k)
    for k in batch:
        np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
    _bf16_close(loss, grads, *mk.reference(params, batch), "stored reference")


def test_moe_bf16_loss_grads_match_reference():
    """On the CPU the bf16 expert products upcast to float32 under autograd,
    so each input's gradient is a float32 product rounded once to bf16, as
    ``_MixedBmm`` gives it on the card: the loss and every gradient against
    the reference's ``jax.value_and_grad``."""
    import make_moe_bf16_reference as mk

    params, batch, _, _ = _bf16_case()
    want_loss, want = mk.reference(params, batch)
    got_loss, got = _port_bf16_loss_grads(params, batch, torch.device("cpu"))
    _bf16_close(got_loss, got, want_loss, want, "cpu")


@pytest.mark.cuda
def test_moe_bf16_loss_grads_on_card_match_reference(monkeypatch):
    """granite SMOKE in bf16 compute on the card, its expert products
    through ``_MixedBmm``: the loss and every gradient of
    ``transformer.loss_fn`` against the reference's jitted ``jax.grad``
    (computed on the CPU, stored by ``tests/make_moe_bf16_reference.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import moe

    calls = []
    apply = moe._MixedBmm.apply
    monkeypatch.setattr(moe._MixedBmm, "apply",
                        lambda *a: calls.append(1) or apply(*a))
    params, batch, want_loss, want = _bf16_case()
    got_loss, got = _port_bf16_loss_grads(params, batch, torch.device("cuda"))
    assert calls, "the expert products never took _MixedBmm"
    _bf16_close(got_loss, got, want_loss, want, "cuda")
