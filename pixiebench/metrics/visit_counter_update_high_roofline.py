"""Layer ``kernels/visit_counter.py`` (``csrc/visit_counter.cu``), device
trace: the least time the stretch's visit events and the distinct bins
they touch need (``roofline.py``) over the kernel's profiled device time.
Moves ``throughput_qps``."""

from pixiebench import devtrace, roofline


def read(run):
    if run.trace is None:
        return None
    measured = devtrace.kernel_seconds(run.trace, "update_high_kernel")
    if measured <= 0:
        return None
    return roofline.share(roofline.counter_least_s(run.work()), measured)
