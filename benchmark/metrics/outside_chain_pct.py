"""Per cent of the card's time, from the first runner call's device start
to the last one's device end, that lies outside the superstep's own work
(the launches of a chain kernel, the replays of a captured chain): seed
draws, record copies, gathers, and idle while the host prepares the next
launch.  Read from the spans' timing events."""

from benchmark.metrics._spans import outside_pct, spans


def read(rec):
    return outside_pct(spans(rec) or [])
