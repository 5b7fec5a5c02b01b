"""Experiment reproductions on the port (counterparts of
``pmpx/experiments``).

| Module        | Reference protocol |
|---------------|--------------------|
| error_boxplot | SP/MP/PMP repeated-mean boxplots on N(0,1), ``simple_sampling/error/error.py:191-214`` |
| banana        | 2-D banana sampling + hist2d, ``banana_data.ipynb`` |
| lb_grid       | robustness grid alpha x {MH, MP, PMP} on Bayesian linreg, ``simple_net/lb.py:377-423`` |
| convergence   | beta-trace convergence runs, ``MH_MP_PMP_Compare_convergence/conv_*.cu`` |
| cores_sweep   | convergence vs parallelism P with a wall-clock cap, ``MP_and_PMP_Convergence_with_Cores`` |
| ess_msjd      | ESS/s and MSJD/s vs P, root path or every slot's draw, ``MP_and_PMP_ESS_per_sec_and_MSJD_per_sec`` |
| time_analysis | per-iteration time grid {500, 100k} x {4, 1024}, ``MP_and_PMP_time_analysis`` |
| skewness      | skewness of chain means vs iterations (chain-batched), ``simple_net/skewness/skewness.ipynb`` |
| correlation   | (d, D, C) sweep csv, ``complex_nets/correlation/com_dim.py`` |
| mnist         | {FC, CNN, LSTM} x {MH, MP, PMP} NN posteriors, checkpointed chunks, ``complex_nets/Mnist`` |
| cifar_hmc     | SP/MP/PMP-HMC on LeNet, ``complex_nets/Cifar-10`` |
| bnn           | PMP-HMC over a mean-field BNN, ``Bayesian Network Training/main.py`` |
| multichain    | R-hat / per-chain ESS over chain-batched runs or the fused chain farm, one card (beyond the reference) |
| nn_perf       | NN-zoo µs per superstep, the LeNet gradient's peak memory by layout and lever, bf16 studies (beyond the reference) |
| resilience    | SIGKILL a checkpointed chain mid-chunk, resume, the trace bitwise identical (beyond the reference) |

Every module exposes ``run(**overrides) -> dict`` (summary scalars, the
keys of its ``pmpx`` counterpart) and takes ``device`` (CUDA unless the
caller names another); traces are saved via
``pmpx_torch.metrics.recorder``.  All of ``pmpx``'s experiments are
ported, in its order.
"""

EXPERIMENTS = [
    "error_boxplot",
    "banana",
    "lb_grid",
    "convergence",
    "cores_sweep",
    "ess_msjd",
    "time_analysis",
    "skewness",
    "correlation",
    "mnist",
    "cifar_hmc",
    "bnn",
    "multichain",
    "nn_perf",
    "resilience",
]
