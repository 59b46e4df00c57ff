"""Multi-pod dry run: trace every (arch x shape x mesh) cell's per-rank
program on fake tensors and reckon its memory, work and collectives.

Twin of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 512 placeholder TPU devices; the port runs one rank's
program (``launch/cells.py``) eagerly on fake tensors over a fake process
group of the mesh's world size, as rank 0 (``launch/fake.py``), and
reads what it did:

  * ``memory_analysis``: the argument blocks' bytes, the outputs' bytes,
    and ``temp_size`` = the peak of the live storages less the arguments;
  * ``flops`` by the product's dtype, ``hbm_bytes``, ``collectives`` by
    kind and ``coll_by_axis`` (``launch/hlo_analysis.py``), each
    all-gather's result by shape and dtype under its axes
    (``gathers_by_axis``), and the three roofline terms on H100 SXM5
    data-sheet constants;
  * ``kernels``: the hand kernels' fake calls (``kernels._build.launches``
    stays 0: nothing launches);
  * ``form``: ``"fixed"`` where a data-dependent loop ran at its static
    bound (the cells' docstring lists every such place), else ``"real"``.

Usage (``PYTHONPATH=src``):
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --subprocess
  python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k \\
      --mesh one --params '{"global_batch": 8}'

``--mesh`` takes ``single`` (16, 16), ``multi`` (2, 16, 16), ``both``,
``one`` (a one-rank (1, 1) mesh, to set a reckoning beside a card's
measurement), or ``small`` (2, 4) (a fake world for SMOKE configs);
``--params`` overrides the cell's shape params.  The fake
process group is process-global, so one process runs one world size;
``--subprocess`` runs each cell in a process of its own, or with
``--jobs N`` N worker processes a mesh, each tracing its share of the
cells (spread longest first: LM training, then prefill).  Records are
appended to ``--out`` (``results/dryrun.jsonl``).  No reckoning here is a
measurement.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "one": ((1, 1), ("data", "model")),
    "small": ((2, 4), ("data", "model")),
}


def _storages(tree) -> dict:
    """Distinct storages of a tree's tensors (a DTensor's local) -> bytes."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.training import tree as tree_lib

    out = {}
    for x in tree_lib.leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def run_cell(arch: str, shape: str, mesh_kind: str, n_micro: int = 4,
             params: dict = None, config=None) -> dict:
    """Trace one cell's rank-0 program and reckon it (the module docstring);
    ``params`` overrides the shape cell's params, ``config`` the arch's
    config (a test's SMOKE widths)."""
    import torch

    from repro_torch import abstract
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import cells as cells_lib
    from repro_torch.launch import fake
    from repro_torch.launch.hlo_analysis import analyze_tally, collective_bytes
    from repro_torch.launch.mesh import process_group_mesh
    from repro_torch.training import tree as tree_lib

    spec = get_arch(arch)
    if config is not None:
        spec = dataclasses.replace(spec, config=config)
    cell_spec = next(c for c in spec.shapes if c.name == shape)
    if params:
        cell_spec = dataclasses.replace(cell_spec, params={**cell_spec.params, **params})
    dims, axes = MESHES[mesh_kind]
    n_chips = 1
    for d in dims:
        n_chips *= d
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "n_chips": n_chips, "kind": cell_spec.kind, "status": "start",
    }
    if params:
        rec["params"] = params
    t0 = time.time()
    fake.start_fake_world(n_chips)
    mesh = process_group_mesh(dims, axes, device="cpu")
    axis_of = cells_lib.axis_groups(mesh)
    kw = {"n_micro": n_micro} if spec.family == "lm" else {}
    cell = cells_lib.build_cell(spec, cell_spec, mesh, dry=True, **kw)
    rec["form"] = cell.form
    launches_before = sum(_build.launches.values())
    with abstract.fake_tensor_mode(), abstract.reckon_card():
        whole = tree_lib.tree_map(
            lambda m: torch.empty(m.shape, dtype=m.dtype, device="cpu"), cell.args)
        local = cells_lib.place(cell, whole)
        del whole
        arg_st = _storages(local)
        tally = fake.Tally(axis_of)
        tally.track(local)
        t1 = time.time()
        with tally:
            out = cell.fn(*local)
        rec["trace_s"] = time.time() - t1
        peak = tally.peak_bytes
        out_st = _storages(out)
    if sum(_build.launches.values()) != launches_before:
        raise AssertionError("the dry run launched a kernel")
    arg_bytes = sum(arg_st.values())
    out_bytes = sum(b for k, b in out_st.items() if k not in arg_st)
    rec["memory_analysis"] = {
        "argument_size": arg_bytes,
        "output_size": out_bytes,
        "temp_size": max(peak - arg_bytes, 0),
    }
    rec["peak_bytes"] = peak
    rec["collectives"] = {k: v for k, v in collective_bytes(tally).items() if v > 0}
    rec["coll_by_axis"] = dict(tally.coll_by_axis)
    rec["gathers_by_axis"] = {a: dict(g) for a, g in tally.gathers.items()}
    rec["kernels"] = dict(tally.kernels)
    rec["n_ops"] = tally.n_ops
    rec["top_bytes"] = dict(sorted(tally.bytes_by_op.items(), key=lambda kv: -kv[1])[:6])
    terms = analyze_tally(tally, mesh, n_chips, bytes_per_device=float(peak))
    rec.update(terms.as_dict())
    rec["seconds"] = time.time() - t0
    rec["status"] = "ok"
    return rec


def _fmt(rec: dict) -> str:
    if rec["status"] != "ok":
        return (f"FAIL {rec['arch']}/{rec['shape']}/{rec['mesh']}: "
                f"{rec.get('error', '?')}")
    ma = rec["memory_analysis"]
    gb = (ma["argument_size"] + ma["temp_size"]) / 1e9
    fl = " ".join(f"{k}={v:.3e}" for k, v in sorted(rec["flops_by_dtype"].items()))
    return (
        f"OK {rec['arch']}/{rec['shape']}/{rec['mesh']} "
        f"chips={rec['n_chips']} GB/rank={gb:.2f} of 80 flops[{fl}] "
        f"hbm={rec['hbm_bytes']:.3e} coll/dev={rec['coll_bytes_per_dev']:.3e} "
        f"tc={rec['t_compute_s']:.2e}s tm={rec['t_memory_s']:.2e}s "
        f"tcoll={rec['t_collective_s']:.2e}s dom={rec['dominant']} "
        f"form={rec['form']} ({rec['seconds']:.1f}s)"
    )


def all_cells():
    from repro_torch.configs import all_archs, get_arch

    for arch in all_archs():
        spec = get_arch(arch)
        for cell in spec.shapes:
            yield arch, cell.name


def _env() -> dict:
    """This process's environment with the package's ``src`` on the path."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


# rough seconds a cell takes to trace, for spreading cells over workers
_COST = {"train": 150.0, "prefill": 60.0}


def _cost(cell) -> float:
    """LM training and prefill trace ~1M and ~0.4M operations; the rest a
    few thousand."""
    from repro_torch.configs import get_arch

    arch, shape, _ = cell
    spec = get_arch(arch)
    kind = next(c.kind for c in spec.shapes if c.name == shape)
    return _COST.get(kind, 3.0) if spec.family == "lm" else 3.0


def _run_subprocesses(todo, args) -> int:
    """The cells in processes of their own: one a cell, one after another
    (``--jobs 1``), or ``args.jobs`` worker processes at once for each
    mesh, each given its share of the mesh's cells, longest first (a
    worker pays its start once; the fake process group allows one world
    size a process).  Each writes its records to a file of its own,
    appended to ``args.out`` as it ends."""
    import tempfile

    if args.jobs <= 1:
        rounds = [[[c]] for c in todo]
    else:
        rounds = []
        for kind in dict.fromkeys(m for _, _, m in todo):
            bins = [[0.0, []] for _ in range(args.jobs)]
            for cell in sorted((c for c in todo if c[2] == kind), key=_cost, reverse=True):
                b = min(bins, key=lambda x: x[0])
                b[0] += _cost(cell)
                b[1].append(cell)
            rounds.append([b[1] for b in bins if b[1]])
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    failures = 0
    for shares in rounds:
        running = []
        for i, share in enumerate(shares):
            out = os.path.join(tmp, f"worker{i}.jsonl")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
                   ",".join(":".join(c) for c in share), "--out", out,
                   "--n-micro", str(args.n_micro)]
            if args.params:
                cmd += ["--params", args.params]
            running.append((subprocess.Popen(cmd, env=_env()), out))
        for proc, out in running:
            failures += proc.wait() != 0
            if os.path.exists(out):
                with open(out) as src, open(args.out, "a") as dst:
                    dst.write(src.read())
                os.unlink(out)
    os.rmdir(tmp)
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both", "one", "small"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--subprocess", action="store_true",
                    help="one process per cell (isolation)")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells already recorded OK in --out")
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--params", default=None,
                    help="JSON object overriding the cell's shape params")
    ap.add_argument("--jobs", type=int, default=1,
                    help="with --subprocess: worker processes at once")
    ap.add_argument("--cells", default=None,
                    help="arch:shape:mesh,... (a worker's share)")
    args = ap.parse_args(argv)
    params = json.loads(args.params) if args.params else None

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = (
        list(all_cells()) if args.all else [(args.arch, args.shape)]
    )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.skip_done and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") == "ok":
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    todo = [(a, sh, m) for a, sh in cells for m in meshes if (a, sh, m) not in done]
    if args.cells:
        todo = [tuple(c.split(":")) for c in args.cells.split(",")]
    if args.subprocess:
        return _run_subprocesses(todo, args)
    failures = 0
    for arch, shape, mesh_kind in todo:
        try:
            rec = run_cell(arch, shape, mesh_kind, args.n_micro, params)
        except Exception as e:
            rec = {
                "arch": arch, "shape": shape, "mesh": mesh_kind,
                "status": "fail", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:],
            }
            failures += 1
        print(_fmt(rec), flush=True)
        with open(args.out, "a") as f:
            slim = {k: v for k, v in rec.items() if k != "traceback"}
            f.write(json.dumps(slim) + "\n")
        if rec["status"] != "ok" and "traceback" in rec:
            print(rec["traceback"], file=sys.stderr, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
