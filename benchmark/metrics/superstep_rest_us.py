"""Device µs a superstep in kernels other than the likelihood's
``rss_kernel``: the tree, the walk, the selection and the runner."""

from benchmark.metrics._trace import per_superstep_us


def read(rec):
    return per_superstep_us(rec, lambda n: "rss_kernel" not in n)
