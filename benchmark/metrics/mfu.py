"""Per cent of the card's peak for the configuration's dtype that the whole
superstep's counted operations reach at the window's rate."""

from benchmark.metrics._trace import peak_flops


def read(rec):
    peak, counts = peak_flops(rec), rec["counts"]
    if peak is None or counts is None:
        return None
    flops, _ = counts.superstep(rec["config"], rec["traffic"])
    return 100.0 * flops * rec["supersteps"] / rec["window_s"] / peak
