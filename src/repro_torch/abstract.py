"""Abstract tensors: meta stand-ins, fake tensors, and the dry run's route.

It depends on torch alone.  The modules that give out abstract stand-ins
(``abstract_params``, ``abstract_kv_cache``, ``graph_abstract``, ...) and
the kernel wrappers whose route a dry run sets import it; the launch
layer (``launch/fake.py``, ``launch/dryrun.py``) sits above them all.

**Fake tensors on the CPU, reckoned for the card.**  A torch built
without CUDA cannot run autograd on fake ``cuda`` tensors (autograd's
input metadata asks the CUDA device guard for a stream, and the process
aborts), so a dry run's tensors are fake CPU tensors on every host, and
within ``reckon_card`` the port takes the card's route for them: the
kernel wrappers (``ops._kernel_for``), ``moe.expert_matmul`` and
``embedding.gather_rows``' backward.  The card's host and a CPU host trace
the same path.  Outside ``reckon_card`` nothing here changes a route.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode


def fake_tensor_mode() -> FakeTensorMode:
    """A ``FakeTensorMode`` that turns any real tensor it meets into a fake
    one (the fabrics' shard ids are made before it is entered)."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def meta(shape, dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract_of(fn: Callable):
    """``fn()``'s tree with every tensor leaf a meta tensor of its shape
    and dtype: ``jax.eval_shape``.  ``fn`` runs on fake tensors, so an
    initialiser at full width allocates nothing."""
    from repro_torch.training import tree as tree_lib

    with fake_tensor_mode():
        out = fn()
    return tree_lib.tree_map(lambda x: meta(x.shape, x.dtype)
                             if isinstance(x, torch.Tensor) else x, out)


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


_reckoning = False


@contextlib.contextmanager
def reckon_card() -> Iterator[None]:
    """Within this context a fake tensor takes the card's route."""
    global _reckoning
    prev, _reckoning = _reckoning, True
    try:
        yield
    finally:
        _reckoning = prev


def reckons_card(t) -> bool:
    """``t`` is a fake tensor of a dry run that reckons the card's path."""
    return _reckoning and is_fake(t)
