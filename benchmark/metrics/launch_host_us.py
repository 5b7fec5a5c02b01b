"""Mean host µs of one call of the chain runner (``fused.run``,
``farm.run``, ``chain.run``): the host's cost of a launch, to set beside
the card's."""

from benchmark.metrics._spans import host_us, spans


def read(rec):
    return host_us(spans(rec) or [])
