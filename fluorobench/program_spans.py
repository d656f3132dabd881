"""What the program recorded in a traced window, for the metric readers:
its spans and counters (``deepfluoro_tpu_torch.utils.profiling.
recorded()``). The recorder records only while a profiler runs, and the
harness's trace covers exactly the window. A program without the recorder
gives none, and the readers then return None."""

import statistics


def recorded():
    """(spans, counters), or ([], {}) where the program has no recorder."""
    try:
        from deepfluoro_tpu_torch.utils.profiling import recorded as program_recorded
    except ImportError:
        return [], {}
    return program_recorded()


def ms(s) -> float:
    return (s.end_ns - s.start_ns) / 1e6


def durations_ms(*names) -> list[float]:
    """Each recorded span of any of ``names``, in ms."""
    spans, _ = recorded()
    return [ms(s) for s in spans if s.name in names]


def median_ms(name: str) -> float | None:
    d = durations_ms(name)
    return statistics.median(d) if d else None


def median_per_id_ms(*names) -> float | None:
    """The median over ids of the summed spans of ``names`` with that id,
    in ms."""
    spans, _ = recorded()
    per_id = {}
    for s in spans:
        if s.name in names:
            per_id[s.id] = per_id.get(s.id, 0.0) + ms(s)
    return statistics.median(per_id.values()) if per_id else None
