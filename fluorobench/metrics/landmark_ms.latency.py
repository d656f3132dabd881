"""Median of the harness's span around ``detect_landmarks`` on one frame's
labels and heats (their copy to the card, the decode, the rows and
columns back on the host), in ms."""

import statistics


def read(run):
    s = run.spans.times.get("landmarks")
    return 1e3 * statistics.median(s) if s else None
