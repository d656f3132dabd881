"""Median host time of one iteration of fit's batch loop in the window
(``fit(...)["step_seconds"]``: the batch gather, the step up to its loss on
the host, the loop's bookkeeping), in ms."""

import statistics


def read(run):
    s = run.values.get("step_seconds")
    return 1e3 * statistics.median(s) if s else None
