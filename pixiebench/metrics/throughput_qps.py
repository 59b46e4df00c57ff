"""End to end, host clock: every request answered in the window over the
window's length.  A closed loop's window closes at the first harvest past
``--seconds``, so it holds whole cycles of answers and all their time."""


def read(run):
    return run.answered_in_window / run.seconds
