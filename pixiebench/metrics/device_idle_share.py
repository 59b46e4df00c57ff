"""Device (H100), device trace: the share of the profiled stretch in which
no device operation ran.  Moves ``throughput_qps``."""


def read(run):
    if run.trace is None or run.trace_window_s <= 0 or not run.trace.n_device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace_window_s)
