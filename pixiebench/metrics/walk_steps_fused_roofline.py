"""Layer ``kernels/walk_step.py`` (``csrc/walk_steps_fused.cu``), device
trace: the least time the stretch's walker-steps need (``roofline.py``)
over the kernel's profiled device time.  Moves ``throughput_qps``."""

from pixiebench import devtrace, roofline


def read(run):
    if run.trace is None:
        return None
    measured = devtrace.kernel_seconds(run.trace, "walk_steps_fused_kernel")
    if measured <= 0:
        return None
    least = roofline.walk_least_s(run.work(), run.config["walk"]["chunk_steps"])
    return roofline.share(least, measured)
