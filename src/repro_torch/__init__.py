"""PyTorch/CUDA port of the Pixie retrieval engine (``src/repro`` twin).

Laid out module for module like ``repro``: ``repro_torch/core/walk.py`` is
the twin of ``repro/core/walk.py``, and so on.  The port imports torch,
numpy and the standard library only; the JAX package stays the reference
it is held against (``tests/test_torch_*.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
On the card the walk and visit-counter kernels are hand-written CUDA C++
for ``sm_90a`` (``kernels/csrc``); on the CPU every kernel wrapper takes
its plain PyTorch twin, chosen by the device of the tensors it is given.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
