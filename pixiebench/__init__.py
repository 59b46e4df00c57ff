"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of Pixie.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything the
yardstick needs lives here: the graph generator (``graphgen``), the
traffic generator (``traffic``) and its mixes (``traffic/``), the
configurations (``configs/``), the plain reference (``reference``) and the
comparison that decides ``correct`` (``checks``), the trace reading
(``devtrace``), the peaks and work counts (``roofline``), and one reader a
metric (``metrics/``).  Nothing here imports JAX or the JAX package, and
the reference imports nothing of the port.
"""
