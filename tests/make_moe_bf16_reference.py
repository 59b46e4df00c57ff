"""Write the reference's bf16 MoE loss and gradients for the card's test.

``tests/test_torch_dryrun.py::test_moe_bf16_loss_grads_on_card_match_reference``
holds the port's bf16 MoE training path on the card (the expert products'
``moe._MixedBmm`` backward) against ``jax.value_and_grad`` of the
reference's ``transformer.loss_fn``.  The machine with the card has no
jax, so this script computes the reference's side once on the CPU and
keeps it in ``tests/data/granite_smoke_bf16.npz``: granite SMOKE in bf16
compute, the port's ``init_params`` (seed 0) as the parameters, a seeded
4 x 16 batch, the loss and every gradient leaf.  The CPU tests hold the
file against a fresh reference run.  Run from the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/make_moe_bf16_reference.py
"""

import dataclasses
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent / "data" / "granite_smoke_bf16.npz"
BATCH = (4, 16)


def inputs():
    """The port's parameters (names -> float32 arrays) and the batch."""
    import torch

    from repro_torch.configs import granite_moe_3b_a800m
    from repro_torch.models import transformer
    from repro_torch.training import tree

    cfg = dataclasses.replace(granite_moe_3b_a800m.SMOKE, compute_dtype=torch.bfloat16,
                              cache_dtype=torch.bfloat16)
    names, leaves = tree.flatten_with_names(
        transformer.init_params(torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32),
             "mask": (rng.random(BATCH) < 0.8).astype(np.float32)}
    return dict(zip(names, (x.numpy() for x in leaves))), batch


def reference(params: dict, batch: dict):
    """The reference's jitted loss and gradients (names -> arrays)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import granite_moe_3b_a800m as jgran
    from repro.models import transformer as jtf

    cfg = dataclasses.replace(jgran.SMOKE, compute_dtype=jnp.bfloat16,
                              cache_dtype=jnp.bfloat16)
    tree = {}
    for name, x in params.items():      # "['blocks']/['moe']/['router']" -> nested
        keys = [k[2:-2] for k in name.split("/")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(x)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, batch["tokens"], batch["labels"], batch["mask"], cfg)))(tree)
    flat = {}
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        flat["/".join(f"['{p.key}']" for p in path)] = np.asarray(g)
    return float(loss), flat


def main():
    params, batch = inputs()
    loss, grads = reference(params, batch)
    assert sorted(grads) == sorted(params)
    OUT.parent.mkdir(exist_ok=True)
    np.savez_compressed(OUT, loss=np.float32(loss), **batch,
                        **{f"param|{k}": v for k, v in params.items()},
                        **{f"grad|{k}": v for k, v in grads.items()})
    print(f"wrote {OUT}: loss {loss}")


if __name__ == "__main__":
    main()
