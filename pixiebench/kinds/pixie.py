"""The kind ``pixie``: a Pixie retrieval replica served by the port's
``PixieServer`` over a graph drawn from the seed (``harness.py``), held to
the plain reference on the four exact numbers of ``checks.py``.  A
configuration that names no kind is of this one."""

from pixiebench import checks, graphgen, harness, reference, roofline, traffic

run_cell = harness.run_cell
LIMITS = checks.LIMITS
REFERENCE_MODULES = (reference, graphgen, checks, roofline, traffic)
