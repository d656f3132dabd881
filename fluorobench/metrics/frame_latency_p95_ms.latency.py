"""The 95th percentile of the window's frame latencies (hand-in of the raw
host frame to labels, heats and landmarks on the host), over all frames of
the window, in ms. Most of the tail lies in ``fullres_batches``' dispatch
of the members' forwards, which the host's speed sets."""


def read(run):
    return run.values.get("latency_p95_ms")
