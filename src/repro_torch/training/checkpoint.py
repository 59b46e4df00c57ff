"""Atomic, keep-last-k checkpoints, in the reference's on-disk layout.

Twin of ``repro/training/checkpoint.py``:

    <dir>/step_<8 digits>/arrays.npz   one array a leaf, ``a0``, ``a1``, ...
    <dir>/step_<8 digits>/meta.json    {"step": n, "names": [...]}
    <dir>/LATEST                       the newest step's directory name

A step is written under ``step_<n>.tmp`` and moved into place with
``os.replace``; ``LATEST`` is written to ``LATEST.tmp`` and moved last, so
a crash mid-save leaves the previous restore point whole; only the newest
``keep_last`` steps stay.  ``names`` are the leaves' paths as the
reference writes them (jax's key paths in jax's leaf order, dict keys
sorted: ``[0]/['blocks']/['wq']``, ``[1]/.m/['embed']``, ``[1]/.step``),
so each package restores the other's float32 / int32 checkpoints.

bf16 leaves: numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf
is stored as its 16 bits (an int16 array) and its name listed under
``meta.json``'s ``"bfloat16"``; the port reads it back bit for bit (the
reference would read the integers).

Meshes: a DTensor leaf (``sharding.place``) is saved whole, gathered
over its ranks, so a checkpoint does not depend on the mesh it came from.
Under a started process group every rank calls ``save``: the process of
global rank 0 writes, and every rank returns after a barrier, once the
step and ``LATEST`` are in place, so any rank may restore it next.
``restore(..., shardings=)`` places the restored leaves on another mesh,
each rank keeping its block (the reference's elastic restart);
``device=`` is the one-device form.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.distribution import sharding
from repro_torch.training import tree as tree_lib

PyTree = Any


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):      # a DTensor: gathered whole
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: PyTree, keep_last: int = 3) -> str:
    """Atomically persist ``tree`` as step ``step``. Returns the final path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    names, leaves = tree_lib.flatten_with_names(tree)
    arrays = {f"a{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    started = dist.is_available() and dist.is_initialized()
    try:
        if not started or dist.get_rank() == 0:
            _write(ckpt_dir, final, step, names, leaves, arrays, keep_last)
    finally:
        if started:
            dist.barrier()
    return final


def _write(ckpt_dir, final, step, names, leaves, arrays, keep_last) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "names": names}
    bf16 = [n for n, leaf in zip(names, leaves)
            if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16]
    if bf16:
        meta["bfloat16"] = bf16
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    _gc(ckpt_dir, keep_last)


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    pointer = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(pointer):
        return None
    with open(pointer) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(
    ckpt_dir: str,
    like: PyTree,
    step: Optional[int] = None,
    device: DeviceLike = None,
    shardings: Optional[PyTree] = None,
) -> Tuple[PyTree, int]:
    """Restore into the structure and dtypes of ``like`` (its leaves
    tensors, whole or DTensors) on each leaf's device, or onto ``device``,
    or placed by ``shardings`` (a tree of ``NamedSharding`` matching
    ``like``: DTensors on its process-group mesh, on the mesh's device).
    Refuses a checkpoint whose names or shapes differ from ``like``'s."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    bf16 = set(meta.get("bfloat16", ()))

    names, leaves = tree_lib.flatten_with_names(like)
    if names != meta["names"]:
        raise ValueError(
            "checkpoint structure mismatch: "
            f"{set(meta['names']) ^ set(names)}"
        )
    restored = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, leaf in enumerate(leaves):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {names[i]}: {arr.shape} vs {tuple(leaf.shape)}"
                )
            t = torch.from_numpy(np.require(arr, requirements="W"))
            if names[i] in bf16:
                t = t.view(torch.bfloat16)
            if shardings is not None:
                dev = tree_lib.leaves(shardings)[i].mesh.device
            else:
                dev = device if device is not None else leaf.device
            restored.append(t.to(device=dev, dtype=leaf.dtype))
    tree = tree_lib.unflatten(like, restored)
    if shardings is not None:
        tree = sharding.place(tree, shardings)
    return tree, step
