"""Host seconds the compiled chain spent in its first step and graph
captures (set-up; the program's ``capture_s`` counter)."""

from benchmark.metrics._spans import counter


def read(rec):
    value = counter("capture_s")
    return None if value is None else float(value)
