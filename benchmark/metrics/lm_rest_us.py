"""Device µs a superstep outside the SSD kernel and the matrix products:
the norms, the conv, the gates, the casts of the weights, the loss, the
tree and the selection.  Kernels whose name holds one of PRODUCTS are
taken as matrix products: cuBLAS's and CUTLASS's GEMMs on the H100
(``gemm``, ``nvjet``, ``xmma``, ``cutlass``) and the fused attention's
(``flash``, ``fmha``)."""

from benchmark.metrics._trace import per_superstep_us

PRODUCTS = ("gemm", "nvjet", "xmma", "cutlass", "flash", "fmha")


def _rest(name: str) -> bool:
    low = name.lower()
    return "mamba2_ssd" not in low and not any(p in low for p in PRODUCTS)


def read(rec):
    if rec["counts"] is None or not hasattr(rec["counts"], "ssd_call"):
        return None
    return per_superstep_us(rec, _rest)
