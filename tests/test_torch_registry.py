"""The port's arch registry and abstract stand-ins against the JAX package.

  * ``all_archs()`` equal; every ``ArchSpec`` equal field for field: name,
    family, source, shape cells (names, kinds, params, notes), the rule
    overrides, and ``config`` / ``smoke_config`` recursively through the
    nested config dataclasses, jnp dtypes read as torch's.  The one
    difference by design: pixie's ``FULL.walk`` and ``FULL.sharded_walk``
    carry ``backend="pallas"`` (the hand kernels) where the reference's
    default ``"xla"`` was a TPU lowering;
  * the shared shape tables and ``CRITEO_ROWS``;
  * every abstract stand-in leaf by leaf (names, shapes, dtypes) against
    the reference's ``ShapeDtypeStruct``s at every FULL config:
    ``abstract_params`` of the four model families, ``optim.abstract_state``,
    ``transformer.abstract_kv_cache``, ``embedding.abstract_table``,
    ``graph.graph_abstract``, ``distributed.abstract_sharded_graph`` and
    ``sharded_graph_specs``; each a tree of meta tensors (nothing
    allocated), and at SMOKE shaped like the port's own ``init_params``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.models import dlrm as jdlrm
from repro.models import embedding as jemb
from repro.models import gnn as jgnn
from repro.models import sequential_rec as jseq
from repro.models import transformer as jtf
from repro.training import optim as joptim
from repro_torch.configs import pixie as tpixie
from repro_torch.configs import registry as treg
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import embedding as temb
from repro_torch.models import gnn as tgnn
from repro_torch.models import sequential_rec as tseq
from repro_torch.models import transformer as ttf
from repro_torch.training import optim as toptim
from repro_torch.training import tree

ARCHS = jreg.all_archs()
# the reference's model module -> the port's
MODELS = {"transformer": (jtf, ttf), "sequential_rec": (jseq, tseq),
          "dlrm": (jdlrm, tdlrm), "gnn": (jgnn, tgnn)}
# (field path) -> (reference value, port value) allowed to differ
BY_DESIGN = {("pixie", "config", "walk", "backend"): ("xla", "pallas"),
             ("pixie", "config", "sharded_walk", "backend"): ("xla", "pallas")}


def _dtype_name(x):
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return jnp.dtype(x).name


def _is_dtype(x) -> bool:
    # torch dtypes, numpy dtypes, and scalar types (jnp.float32 is a class
    # with a ``dtype``)
    return (isinstance(x, (torch.dtype, np.dtype))
            or isinstance(x, type) and hasattr(x, "dtype"))


def _diff(j, t, path, out):
    """Every field path where the reference's ``j`` and the port's ``t``
    differ, appended to ``out`` as ``(path, j, t)``."""
    if dataclasses.is_dataclass(j):
        if not dataclasses.is_dataclass(t) or type(j).__name__ != type(t).__name__:
            out.append((path, type(j).__name__, type(t).__name__))
            return
        jf = [f.name for f in dataclasses.fields(j)]
        tf = [f.name for f in dataclasses.fields(t)]
        if jf != tf:
            out.append((path + ("<fields>",), jf, tf))
            return
        for f in jf:
            _diff(getattr(j, f), getattr(t, f), path + (f,), out)
        return
    if _is_dtype(j) or _is_dtype(t):
        if not (_is_dtype(j) and _is_dtype(t)) or _dtype_name(j) != _dtype_name(t):
            out.append((path, j, t))
        return
    if isinstance(j, (tuple, list)):
        if not isinstance(t, (tuple, list)) or len(j) != len(t):
            out.append((path, j, t))
            return
        for i, (a, b) in enumerate(zip(j, t)):
            _diff(a, b, path + (i,), out)
        return
    if isinstance(j, dict):
        if not isinstance(t, dict) or sorted(j) != sorted(t):
            out.append((path, j, t))
            return
        for k in j:
            _diff(j[k], t[k], path + (k,), out)
        return
    if type(j) is not type(t) or j != t:
        out.append((path, j, t))


def test_all_archs_equal_reference():
    assert treg.all_archs() == ARCHS
    assert len(ARCHS) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_spec_equals_reference_field_for_field(arch):
    j, t = jreg.get_arch(arch), treg.get_arch(arch)
    assert isinstance(t, treg.ArchSpec)
    diffs = []
    _diff(j, t, (arch,), diffs)
    unexpected = [d for d in diffs if BY_DESIGN.get(d[0]) != (d[1], d[2])]
    assert not unexpected, unexpected
    if arch == "pixie":
        assert sorted(d[0] for d in diffs) == sorted(BY_DESIGN)
        assert t.config.walk is tpixie.FULL_WALK
        assert t.config.sharded_walk is tpixie.SHARDED_WALK
    else:
        assert not diffs


def test_shape_tables_and_criteo_rows_equal_reference():
    for name in ("LM_SHAPES", "RECSYS_SHAPES", "GNN_SHAPES", "CRITEO_ROWS"):
        diffs = []
        _diff(getattr(jreg, name), getattr(treg, name), (name,), diffs)
        assert not diffs, diffs
    assert tpixie.PIXIE_SHAPES[0].params["n_edges"] == 17_000_000_000


def test_unknown_arch_is_refused_with_the_list():
    with pytest.raises(KeyError, match="qwen2.5-3b"):
        treg.get_arch("no-such-arch")


# ---------------------------------------------------------------------------
# Abstract stand-ins
# ---------------------------------------------------------------------------


def _jleaves(tree_):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_)
    return {"/".join(str(k) for k in path): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for path, x in flat}


def _tleaves(tree_):
    names, leaves = tree.flatten_with_names(tree_)
    for x in leaves:
        assert x.device.type == "meta", "a stand-in allocated"
    return {n: (tuple(x.shape), _dtype_name(x.dtype)) for n, x in zip(names, leaves)}


def _module_of(cfg):
    return MODELS[type(cfg).__module__.rsplit(".", 1)[-1]]


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "pixie"])
def test_abstract_params_and_state_equal_reference(arch):
    jcfg, tcfg = jreg.get_arch(arch).config, treg.get_arch(arch).config
    jm, tm = _module_of(jcfg)
    jp, tp = jm.abstract_params(jcfg), tm.abstract_params(tcfg)
    assert _tleaves(tp) == _jleaves(jp)
    assert _tleaves(toptim.abstract_state(tp)) == _jleaves(joptim.abstract_state(jp))


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "pixie"])
def test_abstract_params_shaped_like_init_params_at_smoke(arch):
    cfg = treg.get_arch(arch).smoke_config
    _, tm = _module_of(cfg)
    real = tm.init_params(torch.Generator().manual_seed(0), cfg)
    names, leaves = tree.flatten_with_names(real)
    want = {n: (tuple(x.shape), _dtype_name(x.dtype)) for n, x in zip(names, leaves)}
    assert _tleaves(tm.abstract_params(cfg)) == want


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-moe-16b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("batch,seq", [(128, 32768), (1, 524288)])
def test_abstract_kv_cache_equals_reference(arch, batch, seq):
    jcfg, tcfg = jreg.get_arch(arch).config, treg.get_arch(arch).config
    assert _tleaves(ttf.abstract_kv_cache(tcfg, batch, seq)) == _jleaves(
        jtf.abstract_kv_cache(jcfg, batch, seq))
    assert _tleaves(ttf.abstract_kv_cache(tcfg, 2, 16, dtype=torch.float32)) == _jleaves(
        jtf.abstract_kv_cache(jcfg, 2, 16, dtype=jnp.float32))


@pytest.mark.parametrize("arch", ["dlrm-mlperf", "dlrm-rm2", "sasrec", "bst"])
def test_abstract_table_equals_reference(arch):
    jt, tt = jreg.get_arch(arch).config.table, treg.get_arch(arch).config.table
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        j, t = jemb.abstract_table(jt, jd), temb.abstract_table(tt, td)
        assert (tuple(t.shape), _dtype_name(t.dtype), t.device.type) == (
            tuple(j.shape), jnp.dtype(j.dtype).name, "meta")


@pytest.mark.parametrize("n_feats", [0, 4])
def test_graph_abstract_equals_reference(n_feats):
    cell = dict(jreg.get_arch("pixie").shapes[1].params)
    args = (cell["n_pins"], cell["n_boards"], cell["n_edges"], n_feats)
    j = jgraph.graph_abstract(*args, offset_dtype=jnp.int32)
    t = tgraph.graph_abstract(*args, offset_dtype=torch.int32)
    for side in ("p2b", "b2p"):
        js, ts = getattr(j, side), getattr(t, side)
        for f in ("offsets", "targets", "feat_bounds"):
            a, b = getattr(js, f), getattr(ts, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert (tuple(b.shape), _dtype_name(b.dtype), b.device.type) == (
                    tuple(a.shape), jnp.dtype(a.dtype).name, "meta")
    assert (t.n_pins, t.n_boards, t.max_pin_degree) == (j.n_pins, j.n_boards, j.max_pin_degree)
    # the default offsets are int64, as the reference's
    assert tgraph.graph_abstract(10, 5, 40).p2b.offsets.dtype == torch.int64


@pytest.mark.parametrize("n_shards", [16, 7])
def test_abstract_sharded_graph_and_specs_equal_reference(n_shards):
    p = jreg.get_arch("pixie").shapes[0].params
    args = (p["n_pins"], p["n_boards"], p["n_edges"], n_shards)
    j, t = jdist.abstract_sharded_graph(*args), tdist.abstract_sharded_graph(*args)
    for f in ("p2b_offsets", "p2b_targets", "b2p_offsets", "b2p_targets"):
        a, b = getattr(j, f), getattr(t, f)
        assert (tuple(b.shape), _dtype_name(b.dtype), b.device.type) == (
            tuple(a.shape), jnp.dtype(a.dtype).name, "meta")
    assert (t.n_pins, t.n_boards, t.n_shards) == (j.n_pins, j.n_boards, j.n_shards)
    js, ts = jdist.sharded_graph_specs("model"), tdist.sharded_graph_specs("model")
    for f in ("p2b_offsets", "p2b_targets", "b2p_offsets", "b2p_targets"):
        assert tuple(getattr(ts, f)) == tuple(getattr(js, f))
    assert (ts.n_pins, ts.n_boards, ts.n_shards) == (0, 0, 0)
