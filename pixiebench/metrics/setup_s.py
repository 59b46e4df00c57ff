"""End to end, host clock: process start to the first timed request:
imports, the graph drawn and compiled on the card, the server and the
traffic made, and one request of the cell's bucket served (which builds
the kernels on a checkout's first run)."""


def read(run):
    return run.setup_s
