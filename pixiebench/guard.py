"""The import guard.

After the window, the process that prints the result may hold no module
of JAX, of its libraries or of the JAX package, compared by the whole top
level name (the part before the first dot): the port's package,
``repro_torch``, only begins with the JAX package's name.  The reference
and the generator it shares with the program may hold nothing of the port
either: no module, and no function or class defined in one.
"""

from __future__ import annotations

import sys
import types
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PORT = "repro_torch"


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = list(sys.modules) if modules is None else list(modules)
    return sorted(n for n in names if _top(n) in FORBIDDEN)


def port_objects(module: types.ModuleType) -> List[str]:
    """Names in ``module`` bound to the port or to JAX: modules, and
    functions or classes defined in their modules."""
    bad = []
    for attr, value in vars(module).items():
        if isinstance(value, types.ModuleType):
            origin = value.__name__
        else:
            origin = getattr(value, "__module__", None)
            if not isinstance(origin, str) or not callable(value):
                continue
        if _top(origin) in FORBIDDEN + (PORT,):
            bad.append(f"{module.__name__}.{attr} -> {origin}")
    return bad
