"""Device µs a superstep in kernels other than ``lstm_fused_kernel``: the
head, the cross-entropy, the z-score, the tree and the selection."""

from benchmark.metrics._trace import per_superstep_us


def read(rec):
    return per_superstep_us(rec, lambda n: "lstm_fused_kernel" not in n)
