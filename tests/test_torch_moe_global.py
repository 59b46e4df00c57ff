"""``moe.moe_ffn_global`` (routing over the global batch across data ranks)
in its local form, against ``moe.moe_ffn`` of the whole batch.

The reference's ``moe_ffn`` without ``ep_shard_map`` runs under GSPMD on
every data rank's tokens: one capacity and one stable expert order for
the global batch, and the aux loss from the global means.  Its one-device
value is therefore ``moe_ffn`` of the whole batch, and the port's
``moe_ffn`` equals the reference's (``tests/test_torch_moe.py``).  Here the
route runs over a ``LocalFabric`` of 2 and 4 data blocks, one block after
another, and is held to the port's ``moe_ffn``:

  * the output, the aux loss and the gradients of a loss of both (router,
    the three expert leaves, the tokens), with padded experts, top 3 and
    a dropping capacity;
  * a NaN token on one block: its own row NaN, every other row as the
    one-device route gives it, the aux NaN (the global mean reads it);
  * the LM ``forward`` / ``loss_fn`` / greedy ``generate`` with a local
    ``(n, 1)`` mesh (``transformer._ffn`` takes the route) against one
    device, on granite and deepseek SMOKE.

Every case asserts that its tokens make the cut bind: some expert's
global count passes the capacity, and the per-block cuts
(``moe.kept_assignments`` with ``n_blocks``) keep another set, so a
per-rank route would fail the comparison.  The tokens are skewed for
that: half of them near one direction.

Tolerance: 2e-6 times max(1, the one-device value's largest magnitude)
(the route sums the probabilities and the expert products' gradients in
another order); NaN positions exact, tokens exact.  No JAX is imported.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_moe_16b, granite_moe_3b_a800m
from repro_torch.core.distributed import LocalFabric
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.serving import decode
from repro_torch.training import tree

TOL = 2e-6
CPU = torch.device("cpu")
D_MODEL, D_FF, TOKENS = 32, 16, 64
# name -> (n_experts, pad_experts_to, top_k, capacity_factor, seed)
CASES = {
    "top2": (8, None, 2, 1.25, 1),
    "top3_padded": (10, 12, 3, 1.0, 2),
    "dropping_padded": (6, 8, 2, 0.5, 3),
}
BLOCKS = (2, 4)


def moe_case(name, device=CPU):
    n_exp, pad, top_k, cf, seed = CASES[name]
    cfg = moe.MoEConfig(n_experts=n_exp, top_k=top_k, d_ff_expert=D_FF, capacity_factor=cf,
                        pad_experts_to=pad)
    rng = np.random.default_rng(seed)
    e = pad or n_exp
    params = {
        "router": rng.normal(size=(D_MODEL, e)) * 0.5,
        "w_gate": rng.normal(size=(e, D_MODEL, D_FF)) * 0.2,
        "w_up": rng.normal(size=(e, D_MODEL, D_FF)) * 0.2,
        "w_down": rng.normal(size=(e, D_FF, D_MODEL)) * 0.2,
    }
    x = rng.normal(size=(TOKENS, D_MODEL))
    x[TOKENS // 2:] = x[TOKENS // 2:] * 0.3 + 2.0 * rng.normal(size=D_MODEL)   # skewed
    as_t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)
    return cfg, {k: as_t(v) for k, v in params.items()}, as_t(x)


def _close(got, want, what):
    got, want = got.detach(), want.detach()
    assert torch.equal(torch.isnan(got), torch.isnan(want)), what
    ok = ~torch.isnan(want)
    if not bool(ok.any()):
        return 0.0
    bound = TOL * max(1.0, float(want[ok].abs().max()))
    err = float((got[ok].double() - want[ok].double()).abs().max())
    assert err <= bound, f"{what}: {err} > {bound}"
    return err


def routes(fn) -> list:
    """``fn()``'s router selections, one a MoE call, captured from
    ``moe.route_logits`` (the other test files' witness reads them too)."""
    got, real = [], moe.route_logits

    def spy(logits, cfg):
        out = real(logits, cfg)
        got.append(out[2])
        return out

    moe.route_logits = spy
    try:
        fn()
    finally:
        moe.route_logits = real
    return got


def assert_global_cut_binds(cfg, sels, n_data: int, what: str) -> list:
    """Some MoE call's global cut drops an assignment (an expert past its
    capacity) and the per-rank cuts (the tokens in ``n_data`` blocks of
    rows, each cut alone) keep another set, so that a per-rank route
    would give other outputs.  ``cfg`` is an ``LMConfig`` or a
    ``MoEConfig``.  Returns each call's (kept globally, kept per rank,
    assignments)."""
    mcfg = getattr(cfg, "moe", None) or cfg
    kept, binds = [], False
    for sel in sels:
        whole = moe.kept_assignments(sel, mcfg)
        split = moe.kept_assignments(sel, mcfg, n_data)
        kept.append((int(whole.sum()), int(split.sum()), sel.numel()))
        binds |= int(whole.sum()) < sel.numel() and bool((whole != split).any())
    assert binds, f"{what}: no global cut binds where the per-rank cuts differ"
    return kept


@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("case", list(CASES))
def test_local_form_equals_moe_ffn_of_the_whole_batch(case, n_blocks):
    cfg, params, x = moe_case(case)
    assert_global_cut_binds(cfg, [moe.route(x, params["router"], cfg)[2]], n_blocks, case)
    leaves = lambda p, xx: [p["router"], p["w_gate"], p["w_up"], p["w_down"], xx]
    outs = []
    for route in ("one", "blocks"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xx = x.clone().requires_grad_(True)
        if route == "one":
            y, aux = moe.moe_ffn(xx, p, cfg)
        else:
            parts, aux = moe.moe_ffn_global(xx, p, cfg, LocalFabric(n_blocks, CPU))
            assert parts.shape == (1, TOKENS, D_MODEL)
            y = parts[0]
        loss = (y * torch.linspace(-1, 1, D_MODEL)).square().sum() + 50.0 * aux
        outs.append((y, aux, torch.autograd.grad(loss, leaves(p, xx))))
    (y0, a0, g0), (y1, a1, g1) = outs
    err = _close(y1, y0, "output")
    _close(a1, a0, "aux")
    names = ("router", "w_gate", "w_up", "w_down", "tokens")
    gerr = {n: _close(a, b, f"grad {n}") for n, a, b in zip(names, g1, g0)}
    print(f"{case} x{n_blocks}: output {err:.3g}, aux {float(a1.detach())!r} vs "
          f"{float(a0.detach())!r}, grads {gerr}")


@pytest.mark.parametrize("n_blocks", BLOCKS)
def test_local_form_serves_a_nan_token_as_moe_ffn(n_blocks):
    """A NaN router row on one block: the global aux is NaN (its mean
    reads the row), the NaN token's own output row NaN, and every other
    row, on every block, the one-device route's."""
    cfg, params, x = moe_case("top3_padded")
    x = x.clone()
    bad = TOKENS - TOKENS // n_blocks + 3          # in the last block
    x[bad, 5] = float("nan")
    y0, a0 = moe.moe_ffn(x, params, cfg)
    parts, a1 = moe.moe_ffn_global(x, params, cfg, LocalFabric(n_blocks, CPU))
    y1 = parts[0]
    assert bool(torch.isnan(a0)) and bool(torch.isnan(a1))
    assert torch.isnan(y1).any(-1).nonzero().flatten().tolist() == [bad]
    _close(y1, y0, "output")


def test_kept_assignments_is_dispatch_keep():
    """The witness's one-block cut is ``dispatch``'s keep, in token order."""
    cfg, params, x = moe_case("dropping_padded")
    _, _, sel = moe.route(x, params["router"], cfg)
    order, _, keep, _ = moe.dispatch(sel, TOKENS, cfg)
    kept = moe.kept_assignments(sel, cfg)
    assert torch.equal(kept.reshape(-1)[order], keep)
    assert int(kept.sum()) < kept.numel()


# ---------------------------------------------------------------------------
# The LM with a local mesh of data blocks
# ---------------------------------------------------------------------------

LM_CASES = {
    "granite": (granite_moe_3b_a800m.SMOKE, {"pad_experts_to": 12}),
    "deepseek": (deepseek_moe_16b.SMOKE, {}),
}


def _lm(name):
    base, moe_kw = LM_CASES[name]
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, **moe_kw))
    params = tf.init_params(torch.Generator().manual_seed(11), cfg)
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(0, 5, (4, 16), dtype=np.int32))   # skewed
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16), dtype=np.int32))
    mask = torch.from_numpy((rng.random((4, 16)) > 0.2).astype(np.float32))
    return cfg, params, tokens, labels, mask


@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_on_local_data_blocks_equals_one_device(name, n_blocks):
    cfg, params, tokens, labels, mask = _lm(name)
    with torch.no_grad():
        assert_global_cut_binds(cfg, routes(lambda: tf.forward(params, tokens, cfg)),
                                n_blocks, name)
    mesh = tmesh.local_mesh((n_blocks, 1), device=CPU)
    with torch.no_grad():
        h0, a0 = tf.forward(params, tokens, cfg)
        h1, a1 = tf.forward(params, tokens, cfg, mesh=mesh)
    _close(h1, h0, "hidden")
    _close(a1, a0, "aux")
    leaves = tree.leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    l0 = tf.loss_fn(params, tokens, labels, mask, cfg)
    g0 = torch.autograd.grad(l0, leaves)
    l1 = tf.loss_fn(params, tokens, labels, mask, cfg, mesh=mesh)
    g1 = torch.autograd.grad(l1, leaves)
    _close(l1, l0, "loss")
    for n, a, b in zip(tree.flatten_with_names(params)[0], g1, g0):
        _close(a, b, f"grad {n}")
    with torch.no_grad():
        want = decode.generate(params, tokens[:, :12], cfg, max_new_tokens=4)
        got = decode.generate(params, tokens[:, :12], cfg, max_new_tokens=4, mesh=mesh)
    assert torch.equal(got, want)
