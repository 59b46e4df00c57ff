"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of Pixie.

``run.py`` runs one cell of ``BENCHMARK.json`` once, by the kind its
configuration names (``kinds/<kind>.py``; ``pixie``, ``harness.py``, where
it names none); every kind drives its window and builds its result line
with ``cellrun``, the driver's contract.  Everything the yardstick needs
lives here: the graph generator (``graphgen``), the
traffic generator (``traffic``) and its mixes (``traffic/``), the
configurations (``configs/``), the plain reference (``reference``) and the
comparison that decides ``correct`` (``checks``), the trace reading
(``devtrace``), the peaks and work counts (``roofline``), and one reader a
metric (``metrics/``).  Nothing here imports JAX or the JAX package, and
the reference imports nothing of the port.
"""
