"""Roofline report: dryrun.jsonl -> a markdown table.

Twin of ``repro/launch/roofline_report.py``.  Adds the analytic
MODEL_FLOPS term per cell (6ND train / 2ND inference, N_active for MoE;
structural estimates for GNN/recsys), the reference's arithmetic, so the
MODEL / counted FLOPs ratio exposes padding, remat and redundancy waste.
The counted FLOPs are the dry run's (``launch/dryrun.py``): every product
one rank's traced program issues, backward and recompute included; every
time in the table is a reckoning on H100 SXM5 data-sheet constants.

  PYTHONPATH=src python -m repro_torch.launch.roofline_report \\
      --infile results/dryrun.jsonl --out results/roofline.md
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

from repro_torch.configs import get_arch


def model_flops(arch: str, shape: str, kind: str) -> Optional[float]:
    """Analytic 'useful' FLOPs for the whole step (all devices)."""
    spec = get_arch(arch)
    cfg = spec.config
    cell = next(c for c in spec.shapes if c.name == shape)
    p = cell.params

    if spec.family == "lm":
        n_active = cfg.active_param_count()
        if kind == "train":
            tokens = p["global_batch"] * p["seq_len"]
            return 6.0 * n_active * tokens
        if kind == "prefill":
            tokens = p["global_batch"] * p["seq_len"]
            return 2.0 * n_active * tokens
        if kind == "decode":
            # one new token per sequence + KV-cache attention reads
            flops = 2.0 * n_active * p["global_batch"]
            attn = (
                4.0 * p["global_batch"] * p["seq_len"]
                * cfg.n_heads * cfg.head_dim * cfg.n_layers
            )
            return flops + attn

    if spec.family == "gnn":
        d = cfg.d_hidden
        if shape == "minibatch_lg":
            b, f = p["batch_nodes"], p["fanout"]
            nodes = b * (1 + f[0] + f[0] * f[1])
            edges = b * (f[0] + f[0] * f[1])
            d_in = p["d_feat"]
        elif shape == "molecule":
            nodes = p["n_nodes"] * p["batch"]
            edges = p["n_edges"] * p["batch"]
            d_in = p["d_feat"]
        else:
            nodes, edges, d_in = p["n_nodes"], p["n_edges"], p["d_feat"]
        fwd = (
            nodes * 2 * d_in * d                       # encoder
            + cfg.n_layers * (nodes * 4 * d * d + edges * d)  # MLPs + agg
            + nodes * 2 * d * p["n_classes"]
        )
        return 3.0 * fwd  # train: fwd + ~2x bwd

    if spec.family == "recsys":
        from repro_torch.models.dlrm import DLRMConfig

        if isinstance(cfg, DLRMConfig):
            mlp = 0
            dims_b = cfg.bot_mlp
            for i in range(len(dims_b) - 1):
                mlp += 2 * dims_b[i] * dims_b[i + 1]
            dims_t = (cfg.top_in,) + cfg.top_mlp
            for i in range(len(dims_t) - 1):
                mlp += 2 * dims_t[i] * dims_t[i + 1]
            inter = 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
            per_row = mlp + inter
            batch = p.get("n_candidates", p.get("batch", 1))
            mult = 3.0 if kind == "train" else 1.0
            return mult * per_row * batch
        # seqrec: per-user transformer encode + head
        d = cfg.embed_dim
        seq = cfg.seq_len + (1 if cfg.kind == "bst" else 0)
        blk_params = 4 * d * d + 2 * d * cfg.ff
        per_user = cfg.n_blocks * (
            2 * seq * blk_params + 4 * seq * seq * d
        )
        if cfg.kind == "bst":
            dims = ((cfg.seq_len + 1) * d,) + cfg.mlp_dims + (1,)
            for i in range(len(dims) - 1):
                per_user += 2 * dims[i] * dims[i + 1]
        if kind == "retrieval":
            # one user encoded; candidates scored by a single dot each
            n_cand = p["n_candidates"]
            if cfg.kind == "bst":
                return per_user * n_cand  # BST re-runs the CTR head per cand
            return per_user + 2.0 * n_cand * d
        batch = p.get("batch", 1)
        mult = 3.0 if kind == "train" else 1.0
        extra = 0.0
        if kind == "train" and cfg.kind == "sasrec":
            extra = (
                3.0 * 2 * batch * cfg.seq_len * (1 + cfg.n_negatives) * d
            )
        return mult * per_user * batch + extra

    return None  # pixie: walk FLOPs are not the useful-work metric


def load_latest(path: str) -> Dict:
    cells: Dict = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_row(r: Dict) -> str:
    """One cell's row; the last column is MODEL / counted FLOPs (the
    reference's MODEL / HLO)."""
    key = f"{r['arch']}/{r['shape']}"
    if r["status"] != "ok":
        return f"| {key} | {r['mesh']} | FAIL | | | | | |"
    mf = model_flops(r["arch"], r["shape"], r["kind"])
    ratio = ""
    if mf is not None and r.get("flops"):
        ratio = f"{mf / r['n_chips'] / r['flops']:.2f}"
    ma = r.get("memory_analysis")
    mem_gb = ""
    if isinstance(ma, dict) and ma.get("temp_size") is not None:
        tot = (ma.get("argument_size") or 0) + (ma.get("temp_size") or 0)
        mem_gb = f"{tot / 2**30:.2f}"
    return (
        f"| {key} | {r['mesh']} | {r['t_compute_s']:.2e} "
        f"| {r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} "
        f"| {r['dominant']} | {mem_gb} | {ratio} |"
    )


HEADER = (
    "| cell | mesh | t_compute (s) | t_memory (s) | t_collective (s) "
    "| dominant | mem/dev (GiB) | MODEL/counted |\n"
    "|---|---|---|---|---|---|---|---|"
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--infile", default="results/dryrun.jsonl")
    ap.add_argument("--out", default="results/roofline.md")
    args = ap.parse_args(argv)

    cells = load_latest(args.infile)
    lines = [HEADER]
    order = sorted(cells)
    for key in order:
        lines.append(fmt_row(cells[key]))
    text = "\n".join(lines) + "\n"
    with open(args.out, "w") as f:
        f.write(text)
    print(text)

    # summary stats
    ok = [r for r in cells.values() if r["status"] == "ok"]
    doms = {}
    for r in ok:
        if r["mesh"] == "single":
            doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print(f"# {len(ok)}/{len(cells)} cells ok; single-pod dominant terms: "
          f"{doms}")


if __name__ == "__main__":
    main()
