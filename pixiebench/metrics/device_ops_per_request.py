"""Layers ``core/walk.py`` loop and ``core/counter.py``, device trace: the
device operations (kernels, copies, sets) of the profiled stretch over
the requests answered in it.  Moves ``throughput_qps``."""


def read(run):
    if run.trace is None or not run.stretch or not run.trace.n_device_ops:
        return None
    return run.trace.n_device_ops / len(run.stretch)
