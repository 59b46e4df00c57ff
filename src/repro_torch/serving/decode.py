"""LM text generation: prefill + greedy/temperature decode loop.

Twin of ``repro/serving/decode.py``: a host loop over
``transformer.prefill`` and ``transformer.decode_step``.  ``backend``
(port only) picks the decode step's attention: ``"pallas"`` the
decode-attention kernel on the card (its twin on the CPU), ``"xla"`` the
plain twin anywhere.

``_sample`` takes the first maximal logit, as ``jnp.argmax`` does
(``torch.argmax`` returns the first maximal index too).  With a
temperature and a key (``prng.key``) it is ``jax.random.categorical``'s
Gumbel-max trick on the reference's bits: ``argmax(gumbel(fold_in(key,
i)) + logits / temperature)``, the noise from ``prng.gumbel`` and the
division a true float32 division, as the reference's eager ``_sample``
divides (a division by a Python float on a CUDA tensor would multiply by
its reciprocal instead, so the temperature is a tensor on the logits'
device).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import prng
from repro_torch.models import transformer as tf


def generate(
    params: Dict[str, Any],
    prompt: torch.Tensor,      # (b, s0) int32
    cfg: tf.LMConfig,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    key: Optional[torch.Tensor] = None,
    *,
    backend: str = "pallas",
    mesh=None,
) -> torch.Tensor:
    """Returns (b, s0 + max_new_tokens) generated token ids.  ``mesh``
    (port only, a ``launch.mesh.Mesh``) reaches the MoE blocks of prefill
    and every decode step: the expert-parallel route of configs with
    ``ep_shard_map``, routing over the global batch in the mesh's data
    blocks without it."""
    b, s0 = prompt.shape
    max_seq = s0 + max_new_tokens
    logits, cache = tf.prefill(params, prompt, cfg, max_seq=max_seq, mesh=mesh)

    tokens = [prompt.to(torch.int32)]
    cur = _sample(logits, temperature, key, 0)
    for i in range(max_new_tokens):
        tokens.append(cur[:, None])
        if i == max_new_tokens - 1:
            break
        logits, cache = tf.decode_step(params, cache, cur, s0 + i, cfg, mesh,
                                       backend=backend)
        cur = _sample(logits, temperature, key, i + 1)
    return torch.cat(tokens, dim=1)


def _sample(logits: torch.Tensor, temperature: float, key, i: int) -> torch.Tensor:
    if temperature <= 0.0 or key is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    noise = prng.gumbel(prng.fold_in(key, i), logits.shape)
    t = torch.tensor(temperature, dtype=logits.dtype, device=logits.device)
    return torch.argmax(noise + logits / t, dim=-1).to(torch.int32)
