"""Seconds from the process's start to the window's first launch (host
clock): imports, CUDA, the kernels' library (nvcc on a checkout's first
run), inputs, warm-up, capture and burn-in."""


def read(rec):
    return rec["setup_s"]
