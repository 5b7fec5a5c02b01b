"""Experiment reproductions on the port (counterparts of
``pmpx/experiments``; only what the port has so far).

| Module        | Reference protocol |
|---------------|--------------------|
| cores_sweep   | convergence vs parallelism P with a wall-clock cap, ``MP_and_PMP_Convergence_with_Cores`` |
| ess_msjd      | ESS/s and MSJD/s vs P, root path or every slot's draw, ``MP_and_PMP_ESS_per_sec_and_MSJD_per_sec`` |
| time_analysis | per-iteration time grid {500, 100k} x {4, 1024}, ``MP_and_PMP_time_analysis`` |

Every module exposes ``run(**overrides) -> dict`` (summary scalars, the
keys of its ``pmpx`` counterpart) and takes ``device`` (CUDA unless the
caller names another); traces are saved via
``pmpx_torch.metrics.recorder``.
"""

EXPERIMENTS = [
    "cores_sweep",
    "ess_msjd",
    "time_analysis",
]
