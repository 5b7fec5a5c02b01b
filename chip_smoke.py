#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pmpx_torch``) on one CUDA card.

Run from the root of the repository, on a machine with an NVIDIA Hopper
card, ``nvcc`` and PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, each printing its wall time:

0. the card, its power limit, the torch and nvcc versions;
1. the kernels' build (``nvcc`` into ``pmpx_torch/_build/``), with the
   registers, shared memory and spills ``ptxas`` reports (and, by name,
   those of every chain kernel: ``chain_{binary,mp}_kernel<kAll>`` and
   ``chain_general_kernel<kAll, depth>``), the tensor-core instructions in
   ``lstm_fused_kernel``'s SASS (``cuobjdump``), and ``linreg_rss``'s
   launch at the sweep's shape (registers, shared memory, cluster size,
   ``cudaOccupancyMaxActiveClusters``);
2. ``linreg_rss`` against its plain version at the shapes the sweep
   paths give it and at the edges of its launch geometry, over every
   padded slot and over the real points only (``n_valid``); 2b. the
   binary tree's kernels against their plain versions; 2c. the granite
   cell's SSD scan and in-place positions at its shapes against their
   plain versions, and one granite superstep's launches
   (:func:`phase2c`, callable alone);
3. ``fused_chain`` (injected uniforms) against its plain version, step by
   step from the kernel's own state; 3b. the same for its flat-MP and
   general modes; 3c. the same for every fused cell of the time grid, on
   the grid's own data, and for the ESS protocol's root cells on its
   target; 3d. the same for ``emit="all"`` in its three modes, slot by
   slot; 3e. the chain farm (C chains in one launch) bit-equal to C
   single-chain launches, and the ESS protocol's farm cell and the
   multichain sweep's farm cells (flat MP with N = P, binary depths 4, 6,
   8), chain by chain, against the plain version; 3f. ``lstm_fused``
   against its plain version at the MNIST-LSTM protocol's shapes in f32
   and bf16, and a replay of PMP supersteps at full batch, kernel path
   against plain path;
4. the sweep main path of the benchmark cell (``pmpx_torch.bench``), with
   its launch counts and a posterior check (``benchmark/run.py`` times it);
5. the fused main path, likewise;
6. each kernel's time beside its plain version's and its bound (the
   launches of each from the time grid of phase 7, the ESS protocol of
   phase 9, the MNIST path of phase 10 and the experiments of phase 11; a
   chain kernel's bound is a floor one SM can meet,
   :func:`chain_sm_bound`), ``lstm_fused``'s beside P calls of cuDNN's
   LSTM (its bf16 weights flattened by hand, and as torch leaves them)
   and its tensor-core and transcendental bounds, the farm's supersteps
   per second against its chain count, each chain kernel's µs per
   superstep against P (:func:`chain_p_sweep`), and where a
   superstep's clocks go, phase by phase, in the stamped chain library
   (:func:`stamp_splits`);
7. the time grid of the reference (``pmpx_torch.experiments.
   time_analysis``) at full width on both paths, with a posterior check of
   a flat-MP and a general fused chain;
8. ``cores_sweep`` on the fused path for PMP and MP, its wall budget cut
   to ``CORES_SET_TIME`` seconds per P (the one reduction);
9. the ESS/MSJD protocol (``pmpx_torch.experiments.ess_msjd``) at the
   paper's data size on the fused path, every slot's draws and the root
   path, one farm of chains, and the superstep path's emit-all cells, with
   the cuts listed in its JSON line;
10. the MNIST posterior (``pmpx_torch.experiments.mnist``) at the paper's
   scale: LSTM PMP, MP and MH through the ``lstm_fused`` kernel and FC PMP
   through the generic path, ``num_steps`` cut (the one reduction), with
   the kernel-path density at the warm start held to the generic path's,
   and a profiler trace of a few LSTM and FC PMP supersteps;
11. the linreg and analytic experiments at the paper's widths (n =
   100,000): ``convergence`` (MH, MP, PMP through ``linreg_rss``, tail
   means held to the least-squares fit), ``lb_grid``, ``correlation``
   (``pmpx``'s committed run of each dim's deepest cell within 4 sd of
   the port's runs at eight seeds),
   ``error_boxplot``, ``banana``, ``skewness`` (64 chains in one batch, one
   ``linreg_rss`` launch a superstep), ``multichain``'s fused farm sweep
   (split-R-hat of every cell) and a chain-batched run, and the native
   runtime (built, a trace read back bit-equal); the step-count cuts listed
   in its JSON line;
12. checkpoint/resume and the HMC samplers at full width (the step counts
   cut, listed in its JSON line): 12a. SP-, MP- and PMP-HMC over the
   linreg posterior at n = 100,000 on the sweep (``linreg_rss`` inside
   ``value_and_grad_batch``), posterior means within 4 sd of the
   least-squares fit; 12b. ``cifar_hmc`` at ``scale="paper"`` (LeNet,
   50,000 / 10,000 images) for each algorithm, straight and interrupted
   after its first chunk and resumed, the traces bit-equal under
   ``torch.use_deterministic_algorithms``, with ms per superstep and peak
   memory; 12c. ``bnn`` likewise (60,000 / 10,000 images, hidden 1024);
   12d. the MNIST-LSTM PMP chain through ``lstm_fused`` in one loop, in
   checkpointed chunks, and interrupted and resumed by ``adopt_prefix_run``,
   bit-equal; 12e. ``resilience`` (SIGKILLed child processes on the card),
   its assembled trace bitwise identical to an uninterrupted child's;
13. the MNIST CNN and the rest of the NN zoo's tooling at full width (the
   step counts cut, listed in its JSON line), under
   ``torch.use_deterministic_algorithms``: 13a. the ``cnn_fast`` density
   at the warm start held to the generic path's, ``mnist.run(model="CNN",
   scale="paper")`` for MH, MP and PMP on the generic path and PMP through
   ``cnn_fast``, with ms per superstep and peak memory, and the
   ``cnn_fast`` chain interrupted after its first chunk and resumed,
   bit-equal; 13b. the channel-packed LeNet's density and gradient at
   theta0 held to LeNet's, and ``cifar_hmc(layout="packed")``; 13c.
   ``nn_perf``'s CNN cells at full batch, ``footprint`` at P = 2 (every
   variant a peak), ``bf16_delta`` on the CNN cells, and a
   ``pmpx_torch.profiling`` trace of CNN supersteps naming its conv and
   GEMM kernels; 13d. ``python -m pmpx_torch.cli doctor`` names the card;
14. the mesh (``pmpx_torch.parallel``) on the benchmark cell (n = 100,000,
   binary P = 1024): 14a. a one-rank NCCL mesh in this process,
   ``run_chains_sharded`` of 8 chains, ``ShardedLinReg`` over the whole
   data, the tree superstep and the meshed farm (8 chains of binary P =
   512) each bit-equal to its unsharded counterpart, and the
   ``ShardedLinReg`` and tree supersteps' chains, declared eager, run as
   the loop and bit-equal to the plain captured chain; 14b. four gloo ranks
   that share the card (child processes, joined with a timeout): data = 4
   and tree = 4 against the sweep and the plain superstep, chains = 4 x 2
   chains bit-equal to each block run alone, the farm over 4 ranks
   bit-equal to 14a's, and (chains 2 x data 2) 1000 supersteps held to
   least squares; each rank prints its device, launches and collective
   routes (gloo copies a CUDA tensor through the host), and the launches
   join the ``kernels`` line.  No scaling figure: four processes share
   one card;
15. the data-sharded NN posterior and sync-BN (``pmpx_torch.parallel.
   ShardedNNPosterior``) at CIFAR-10 LeNet's full width (50,000 stand-in
   images, f32): 15a. a one-rank NCCL mesh in this process, the sharded
   LeNet (nhwc, remat off and on, P = 2) and PackedLeNet (P = 1) against
   ``NNPosterior``: densities and values bit for bit, gradients within
   1e-5 max|g|, and one SP-HMC superstep as ``cifar_hmc`` builds it;
   15b. four gloo ranks that share the card (child processes, 12,500
   images a rank, joined with a timeout): LeNet nhwc (P = 2), PackedLeNet
   (P = 1) and BayesMLP 784-1024-10 over 60,000 MNIST stand-ins (P = 2,
   its noise from one generator seed on every rank) against the unsharded
   posterior within ``pmpx``'s tolerances, and one SP-HMC superstep over
   the sharded LeNet; each rank prints its device, collectives by route,
   peak GiB and ms per ``value_and_grad_batch``.  No hand kernel runs on
   this path (its launches are checked to be none).  No scaling figure.
16. the compiled chain: ``run_chain`` replays a captured CUDA graph of
   ``unroll`` supersteps on the card (every chain of phases 4-15 runs so,
   apart from the supersteps declared eager), held here to its plain
   version ``run_chain_eager`` on the benchmark cell (n = 100,000): 16a.
   PMP binary P = 1024, flat MP N = 7 and the 7 x 3 general tree, unroll
   1 and 3 (with a tail), records, final state and generator state bit
   for bit and one ``linreg_rss`` launch a superstep counted per replay;
   16b. ``resume_chain`` in 4 chunks (its graphs captured in the first
   chunk) bit-equal to the eager chain and its checkpoint's generator
   state; 16c. the sweep's µs per superstep captured and eager (CUDA
   events, alternating), a profiler trace of each (kernels and device
   busy µs a superstep), and each run
   under ``profiling.recording()``, untraced: the card's share outside the
   superstep's own work (``outside_chain_pct``), the host µs a call and
   the device µs a superstep of the replays; 16d. the MNIST-LSTM MH chain
   through ``lstm_fused`` at full batch, captured against eager (bit for
   bit, µs and kernels a superstep); and which supersteps of the whole run
   went eager, and why;
17. the repo's entry points outside the package, as a user runs them
   (the step counts cut, listed in its JSON line): 17a. the two examples
   (``examples/quickstart_torch.py``, ``examples/bayesian_nn_torch.py``)
   as subprocesses at their own sizes, the quickstart's means within 4
   Monte Carlo standard errors of the banana's and bayesian_nn's loss
   falling; 17b. ``scripts/run_zoo_torch.py``'s 12 cells at their widths
   and batch sizes; 17c. a paper queue through
   ``scripts/run_paper_torch.py`` in a temporary directory: the
   MNIST-LSTM MH chain through ``lstm_fused`` SIGKILLed once mid-run and
   resumed by the queue's retry, bit-equal to the same stage run
   straight, CIFAR and BNN HMC at ``scale="paper"``, ``ess_msjd``'s
   emit-all cells on both paths, and the summary
   (``scripts/summarize_paper_torch.py``) counting every stage's
   supersteps; a second run of the queue starts nothing; the stages'
   kernel launches, reported by their processes, join the ``kernels``
   line; 17d. ``scripts/profile_smallp_torch.py`` at its defaults, one
   ``rss_kernel`` launch a superstep.

It ends with a ``{"kernels": [...]}`` line, the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, ...}`` as the last
line.  Any failed check raises, so the script exits non-zero and prints no
``ok``.  Without a CUDA card it fails at once.  It imports nothing of JAX
or of the ``pmpx`` package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
# One SM's issue rates (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0): 32-bit integer multiplies (the IMAD
# pipe, mul.lo and mul.hi) 64 a clock, multi-function-unit results (exp2,
# log2, reciprocal, sqrt, sin, cos) 16 a clock; at the 1.98 GHz boost clock
# behind the peaks above (67 TFLOP/s = 132 SMs x 128 FMA x 2 x 1.98 GHz).
SM_COUNT = 132
SM_CLOCK_HZ = 1.98e9
IMAD_PER_CLOCK = 64
MUFU_PER_CLOCK = 16
MUFU_PER_S = SM_COUNT * MUFU_PER_CLOCK * SM_CLOCK_HZ
# Philox4x32-10: 2 mul.lo and 2 mul.hi a round, 10 rounds
PHILOX_MULS = 40
# csrc/lstm_fused.cu's cell update per (row, unit, step): 5 exp2 (the
# sigmoids of i, f, o, tanh of g and of c) and 3 reciprocals
LSTM_MUFU_PER_CELL = 8

RSS_TOL = 1e-5  # relative to max|rss|: f32 sums of ~1e5 terms, two orders
CHAIN_ATOL = 1e-4
CHAIN_AGREE = 0.99

# phases 4 and 5: supersteps, burn-in, and the fused path's chunk
SWEEP_PATH_STEPS = 2000
SWEEP_BURN = 500
FUSED_STEPS = 100_000
FUSED_BURN = 10_000
FUSED_CHUNK = 1000

# phase 3b: (N, depth) of the flat-MP and general modes; the grid's flat
# P = 4 and P = 1024, P = 200 (lanes above P), conv_pmp's N = 7 x depth 3
# (P = 512), the largest base the general kernel takes at P = 1024, and
# its depths 4 and 5 (each depth is its own instantiation)
NEW_MODES = ((3, 1), (199, 1), (1023, 1), (3, 2), (7, 3), (31, 2), (3, 4),
             (3, 5))
# phase 2: (P, n) of linreg_rss: the bench cell's P = 1024 and the time
# grid's P = 4 (padded to 8) and P = 1024 at n = 500 and 100,000; P = 200
# and P = 8 at other sizes; the ESS protocol's sweep cells, P = 512 and 8
# at n = 100,000; phase 11's at n = 100,000: MH's 2 states (convergence,
# lb_grid), lb_grid's 7 x 2 tree and multichain's 8 chains of 8 (64), and
# skewness' 64 chains of 8 (512); phase 12's: the HMC density calls' 1, 2
# and 4 states (padded to 8) and resilience's depth-5 tree (32); phase
# 14's: 8 chains of 1024 in one batch, a chains rank's 2 chains (2048), a
# data rank's 25,000 (data = 4) and 50,000 points (chains 2 x data 2), a
# tree rank's 256 nodes (tree = 4)
RSS_SHAPES = ((1024, 100_000), (1024, 500), (4, 100_000), (4, 500),
              (200, 100_000), (8, 5000), (512, 100_000), (8, 100_000),
              (2, 100_000), (64, 100_000), (1, 100_000), (32, 100_000),
              (8192, 100_000), (2048, 100_000), (1024, 25_000),
              (1024, 50_000), (256, 100_000))
# and the edges of its launch geometry: cluster sizes 1 to 8, P above one
# wave's width, n with and without a tail of < 4 points
RSS_EDGE_P = (8, 16, 64, 128, 576, 1024, 1088, 2048)
RSS_EDGE_N = (1, 127, 500, 16_384, 100_000, 250_000)
# phase 3c: (N, depth) of the time grid's fused cells: PMP P = 4 (depth 2,
# lanes above P) and P = 1024, MP P = 4 and P = 1024, conv_pmp's N = 7 x 3;
# and of the ESS protocol's root cells (phase 9, on its target): binary and
# flat MP at P = 8, 32, 128, 512
GRID_FUSED = ((1, 2), (1, 10), (3, 1), (1023, 1), (7, 3))
ESS_FUSED = ((1, 3), (1, 5), (1, 7), (1, 9), (7, 1), (31, 1), (127, 1),
             (511, 1))
POSTERIOR_STEPS = 50_000  # phase 7's flat-MP and general posterior chains
POSTERIOR_BURN = 10_000
# phase 8: the wall budget per P (pmpx's default is 5 s, the paper's 180)
CORES_SET_TIME = 2.0
# phase 3d: (N, depth) of emit="all": binary and flat MP at P = 8, 32, 128,
# 512 (the ESS protocol's grid), general (3, 2) and conv_pmp's (7, 3).
# Gates: CHAIN_AGREE of the slot draws equal; the state and the last
# slot's within CHAIN_ATOL where their draws agree; the jump sum within
# CHAIN_ATOL of max(1, J) where every slot agrees; slot 0's b0 bit-equal
# to the state's.
EMIT_SHAPES = ((1, 3), (1, 5), (1, 7), (1, 9), (7, 1), (31, 1), (127, 1),
               (511, 1), (3, 2), (7, 3))
# phase 3e: the farm of FARM_C chains at P = 8 and 512 (binary) and flat MP
# P = 512 bit-equal to single chains; the ESS protocol's farm cell (ESS_CHAINS
# chains of binary P = 512, FARM_STEPS supersteps a launch) on injected
# uniforms against the plain version, with phase 3's gates; phase 6: its
# throughput against the chain count
FARM_C = 4
FARM_STEPS = 1000
FARM_SHAPES = ((1, 3), (1, 9), (511, 1))
FARM_COUNTS = (1, 8, 32, 132, 264)
# and phase 11's multichain sweep cells on its target (n = 100,000, temper
# 50/n, step 0.05, pmpx's overdispersed starts) at FARM_C chains, on
# injected uniforms against the plain version, with phase 3's gates: flat
# MP with N = P (P + 1 = 9 ... 513 states) and the binary depths 4, 6 and 8
# that no other phase holds
MC_N = 100_000
MC_STEP = 0.05
MC_STEPS = 5000  # pmpx's sweep default (run()'s own default is 800)
MC_FARM_SHAPES = tuple((P, 1) for P in (8, 16, 32, 64, 128, 256, 512)) + (
    (1, 4), (1, 6), (1, 8))
# phase 9: the ESS protocol at the paper's n = 100,000; cut: 20,000 steps
# (the paper's 1,000,000) with its burn-in of 2,000; the superstep path's
# emit-all cells at P = 8 and 512 only, 1000 steps with a burn-in of 200
ESS_N = 100_000
ESS_PS = (8, 32, 128, 512)
ESS_STEPS = 20_000
ESS_BURN = 2_000
ESS_CHAINS = 8
ESS_SWEEP_PS = (8, 512)
ESS_SWEEP_STEPS = 1000
ESS_SWEEP_BURN = 200
# phase 3f: (P, split) of lstm_fused at the MNIST protocol's shapes: PMP and
# MP (P = 8) and MH (P = 2, current and proposal) over the 60,000 training
# images, log_prob (P = 1), and the 10,000-image test split (B not a
# multiple of the kernel's 64-row tile, as 60,000 is not either).  Gates:
# f32 max|dh| <= 2e-5 and log-densities within rtol 2e-5 (pmpx's
# tests/test_lstm_kernel.py:43); bf16 log-densities within rtol 0.02 /
# atol 0.05 (:89).  The replay: LSTM_REPLAY PMP supersteps (the protocol's
# N = 7 tree, single, zscore, alpha 1e-4) at full batch on injected noise,
# CHAIN_AGREE of the selections equal and the states bit-equal where they
# are.
LSTM_SHAPES = ((8, "train"), (2, "train"), (1, "train"), (8, "test"))
LSTM_H_TOL = 2e-5
LSTM_LP_RTOL = 2e-5
LSTM_BF16_RTOL, LSTM_BF16_ATOL = 0.02, 0.05
LSTM_REPLAY = 50
# phase 6: cuDNN's f32 LSTM (TF32 off) on the kernel's weights, mapped to
# torch's layout: h_T within this of the kernel's (another summation order
# over 28 steps)
LSTM_LIB_TOL = 1e-4
# phase 10: the MNIST path at scale="paper" (60,000 / 10,000 images,
# pretrain 50, the paper's temper); the one cut is num_steps (the paper's
# 1,000,000 for the LSTM, 500,000 for FC)
# the binary superstep's tree kernels (kernels/pmp_tree.py) against their
# plain versions, phase 2b: (label, chains, depth, d, selection, stabiliser):
# the sweep cell's shape (one chain, and the skewness protocol's 64), the
# LSTM cell's, all_uniform, rows past one block's copy (the grid-wide
# gather) and the deepest tree one block holds.  A draw may differ from the
# plain version's only where its uniform lies within TREE_TOL of a step of
# the plain CDF (the two sum the CDF in other orders); log_accept agrees
# within TREE_TOL.  The sweep and LSTM rows are timed for phase 6.
TREE_CASES = (("sweep", 1, 10, 3, "all_first", "none"),
              ("sweep_64", 64, 10, 3, "all_first", "none"),
              ("lstm", 1, 3, 24_458, "single", "zscore"),
              ("uniform", 8, 4, 3, "all_uniform", "none"),
              ("gather", 2, 7, 1000, "all_uniform", "zscore"),
              ("deepest", 2, 14, 2, "all_first", "none"))
TREE_TIMED = ("sweep", "lstm")
TREE_TOL = 1e-6
# phase 2c: the granite cell's two kernels at its shapes.  The SSD scan
# over (sequences, T, heads, head_dim, d_state) = the cell's 8 proposals x
# 4 sequences of 4,096 positions, 64 heads of 64, d_state 128, in
# bfloat16, within SSD_REL of y's scale of its chunked sums (two float32
# orders, y rounded to bfloat16 on both sides: at most one bfloat16 ulp
# apart, as tests/test_torch_granite_gpu.py holds it); the tree's P = 8
# positions over d = 772,160,448 written over the innovations, bit-equal
# to the plain version; then one granite superstep from the benchmark's
# cell with its launches counted from 0.
SSD_SHAPE = (32, 4096, 64, 64, 128)
SSD_REL = 2.0 ** -7
GRANITE_D, GRANITE_DEPTH, GRANITE_STEP = 772_160_448, 3, 1e-4
GRANITE_CELL = "granite-h-micro-pmp"
MNIST_CELLS = (("LSTM", "pmp", 300), ("LSTM", "mp", 300), ("LSTM", "mh", 600),
               ("FC", "pmp", 600))
MNIST_PROFILE = 5  # supersteps in each profiler trace of phase 10
# phase 11: the linreg and analytic experiments at the paper's widths
# (n = 100,000, the protocols' N, depth, P, dims and chain counts); the
# cuts are step counts only: lb_grid's num_steps (the paper's 2500),
# error_boxplot's number_sample (1000), banana's num_steps (50,000),
# skewness' num_steps (100,000) with its checkpoints scaled alike
LB_STEPS = 1000
ERR_SAMPLES = 200
BANANA_STEPS = 5000
SKEW_STEPS = 5000
SKEW_MARKS = (250, 1000, 2500, 5000)  # the paper's 5k, 20k, 50k, 100k / 20
MC_RHAT_MAX = 1.05  # every coordinate of every multichain sweep cell
# correlation: pmpx's committed run (seed 0) as one draw of the port's law.
# Each dim's depth-5 pooled mean at chain_len 250 lies within CORR_Z sd of
# the mean of the port's runs at seeds 0..CORR_SEEDS-1, the sd widened by
# sqrt(1 + 1/CORR_SEEDS) (a prediction interval); both chains start at 2.5
# and share the transient's bias, which at d = 160 is most of the value
CORR_Z, CORR_SEEDS = 4.0, 8
# pmpx's committed run of the same protocol: each dim's depth-5 pooled
# mean at chain_len 250 (artifacts/correlation/dimension_chains_parallel.csv)
CORR_PMPX = {10: 0.0197143517434597, 20: 0.13868094980716705,
             40: 0.2536238133907318, 80: 0.407172292470932,
             160: 0.8322762846946716}
# phase 12a: the HMC family over the ESS protocol's linreg posterior (n =
# 100,000, temper 1/2000) on the sweep, from (0, 0, 1): (label, SamplerSpec
# fields, supersteps); a third of each chain is burn-in.  Step 0.03 with
# unit momenta: the posterior's stiffest direction (sigma, sd 0.05) is
# stable below a step of ~0.1
HMC_LINREG = (
    ("sp_hmc", dict(algo="sp_hmc", step_size=0.03, num_leapfrog=3), 1500),
    ("mp_hmc", dict(algo="mp_hmc", N=7, step_size=0.03), 400),
    ("pmp_hmc_barker", dict(algo="pmp_hmc", N=1, depth=3, step_size=0.03,
                            rule="barker"), 800),
    ("pmp_hmc_mh_clamp", dict(algo="pmp_hmc", N=1, depth=3, step_size=0.03,
                              rule="mh_clamp"), 800),
    ("pmp_hmc_barker_clamp", dict(algo="pmp_hmc", N=1, depth=3,
                                  step_size=0.03, rule="barker_clamp"), 800),
)
# phase 12b-d: the paper's widths, num_steps cut (the paper's 50,000 for
# CIFAR, 30,000 for the BNN, 1,000,000 for the MNIST LSTM), in chunks
CIFAR_STEPS, CIFAR_CHUNK = 10, 5
BNN_STEPS, BNN_CHUNK = 30, 10
LSTM_CKPT_STEPS, LSTM_CKPT_CHUNK = 20, 10
# phase 12e: resilience at n = 100,000, a depth-5 binary tree (P = 32)
RES_STEPS, RES_EVERY, RES_KILLS, RES_DEPTH = 3000, 500, 2, 5
# ms the child sleeps after each chunk: a chunk of RES_EVERY supersteps takes
# ~25 ms on the card since the tree kernels, too little for a SIGKILL to land
# inside the run before it ends
RES_THROTTLE_MS = 200
# phase 12b-c's fallback gate where torch names an op on the path without a
# deterministic CUDA version: the traces within this, relative
RESUME_RTOL = 1e-5
# phase 13: the MNIST CNN at scale="paper" (60,000 / 10,000 images, pretrain
# 50, N = 7), num_steps and the chunk cut (the paper's 250,000 in chunks of
# 250); the cnn_fast density at the warm start against the generic path's
# in f32 (pmpx's tests/test_cnn_fast.py:36-43); the packed LeNet against
# the nhwc one at theta0 (tests/test_torch_convpack.py: values rtol 1e-5,
# gradients within 1e-4 max|g|); SP-HMC supersteps of the packed cifar_hmc
# (the paper's 50,000; its Adam warm start 10 of cifar_hmc's 30 steps);
# nn_perf's table at full batch (pmpx's 20 iters),
# footprint at P = 2, bf16_delta (pmpx's 32 supersteps); the trace's
# supersteps
CNN_STEPS, CNN_CHUNK = 20, 10
CNN_FAST_RTOL = 2e-5
PACKED_VAL_RTOL, PACKED_GRAD_TOL = 1e-5, 1e-4
PACKED_STEPS, PACKED_CHUNK, PACKED_PRETRAIN = 4, 2, 10
NNPERF_ITERS, FOOTPRINT_P, BF16_ITERS, TRACE_STEPS = 3, 2, 8, 2

# phase 14: the mesh on the benchmark cell (n = 100,000, temper 1e-3, step
# 0.02, all_first, binary depth 10, P = 1024).  14a, a one-rank NCCL mesh
# in this process: P14_CHAINS chains of P14_STEPS supersteps sharded
# against the chain batch, the farm (P14_CHAINS chains of binary P = 512,
# the farm row's shape, one FARM_STEPS-superstep launch) meshed against
# unmeshed, all bit for bit.  14b, P14_WORLD gloo ranks sharing the card,
# each joined within P14_JOIN_S: data = 4 within rtol P14_RTOL of the
# unsharded sweep (only the f32 summation order differs: another launch
# geometry of linreg_rss), tree = 4's log weights within P14_RTOL of the
# plain superstep's relative to max|log-density| (they are differences of
# the log-densities) and its next state within P14_RTOL, chains = 4 x 2
# chains bit-equal to each block run alone, and
# (chains 2 x data 2) P14_DATA_STEPS supersteps, posterior means within 4
# sd of least squares after P14_DATA_BURN
P14_CHAINS, P14_STEPS = 8, 30
P14_WORLD, P14_JOIN_S = 4, 300
P14_EAGER = 5  # 14a: supersteps of each declared-eager chain
P14_RTOL = 1e-5
P14_DATA_STEPS, P14_DATA_BURN = 1000, 300

# phase 15: the data-sharded NN posterior at CIFAR-10 LeNet's full width
# (load_cifar10's 50,000 stand-in images, f32, temper 1).  15a, a one-rank
# NCCL mesh: the nhwc LeNet (remat off and on) at P15_NHWC_P proposals
# and PackedLeNet at P15_PACKED_P, log_prob_batch and the values bit for
# bit, the gradients within P15_GAP max|g| (the backward of the
# concatenated BatchNorm statistics may sum in another order), and one
# SP-HMC superstep as cifar_hmc builds it (N = 7, step 0.1, momentum
# 0.0005; the paper's 50,000 supersteps cut to 1) bit for bit.  15b,
# P15_WORLD gloo ranks sharing the card, each joined within P15_JOIN_S:
# the same LeNets and BayesMLP 784-1024-10 over load_mnist's 60,000
# stand-ins at P15_BNN_P (one generator seed on every rank) within pmpx's
# tolerances (tests/test_sharded_nn.py:62-69: values rtol 2e-5 / atol
# 1e-6, gradients rtol 5e-3 / atol 1e-5) of the unsharded posterior,
# computed in this process first, and the SP-HMC superstep within
# P15_HMC_TOL of the unsharded one on every rank alike
P15_NHWC_P, P15_PACKED_P, P15_BNN_P, P15_BNN_HIDDEN = 2, 1, 2, 1024
P15_GAP = 1e-5
P15_WORLD, P15_JOIN_S = 4, 300
P15_VAL_RTOL, P15_VAL_ATOL = 2e-5, 1e-6
P15_GRAD_RTOL, P15_GRAD_ATOL = 5e-3, 1e-5
P15_HMC_TOL = 1e-5

# phase 16: the compiled chain on the benchmark cell (n = 100,000, temper
# 1e-3, step 0.02, all_first): run_chain's captured CUDA graph against
# run_chain_eager, bit for bit, for PMP binary depth 10 (P = 1024), flat
# MP N = 7 and the 7 x 3 general tree over P16_STEPS supersteps (unroll 1,
# and P16_UNROLL with a tail), and a resume in P16_CHUNKS chunks; the
# sweep's us per superstep both ways over SWEEP_PATH_STEPS supersteps,
# each timed P16_REPS times, alternating; and a profiler trace of
# P16_TRACE supersteps of each (kernels a superstep), and a run of as
# many under profiling.recording() (the runner's spans).  The timed
# captured chain replays P16_SWEEP_UNROLL supersteps a graph: since the
# tree kernels a superstep takes the card ~43 us, and a replay's own cost
# (its launch, the generator's fills, the record copies, and under
# recording the spans' timing events) is no longer small beside one
# superstep, so the card's share in the replays is read where a replay
# holds many
P16_STEPS, P16_UNROLL, P16_CHUNKS = 40, 3, 4
P16_REPS, P16_TRACE, P16_SWEEP_UNROLL = 2, 128, 64
# 16d: the MNIST-LSTM MH chain through lstm_fused (60,000 stand-ins)
P16_LSTM_STEPS, P16_LSTM_TRACE = 200, 20
# and the peak memory of P16_FC_STEPS full-batch MNIST-FC PMP supersteps
# (P = 8 networks over the 60,000 stand-ins), eager and captured
P16_FC_STEPS = 3
# the supersteps of this run that run_chain keeps eager: label -> the
# reason eager_reason gives (phases 14a and 15a fill it, 16 prints it)
EAGER: dict = {}

# phase 17: the repo's entry points outside the package.  17a: the two
# examples as subprocesses, side by side, at their own sizes
# (P17_TIMEOUT_S each); the quickstart's means within P17_Z Monte Carlo
# standard errors (the banana's marginal sds, BANANA_SD, over the root of
# its printed ESS) of the analytic ones.  17b: run_zoo_torch's 12 cells at
# their widths and batch sizes, the MNIST cells' 2000 supersteps cut to
# ZOO_MNIST_STEPS.  17c, in a thread beside 17a and 17b and drained within
# P17_QUEUE_S: a cut paper queue through run_paper_torch, its steps cut:
# the MNIST-LSTM MH chain through lstm_fused (Q_LSTM_STEPS of 1,000,000 in
# chunks of Q_LSTM_CHUNK, its Adam warm start Q_LSTM_PRETRAIN of mnist's
# 50 steps), once SIGKILLed Q_KILL_DELAY_S after its first chunk reached
# the disk and retried, and once straight; CIFAR SP- and PMP-HMC
# (Q_CIFAR_STEPS of 50,000 in chunks of Q_CIFAR_CHUNK, bf16, the warm
# start Q_CIFAR_PRETRAIN of cifar_hmc's 30 steps) and BNN SP- and PMP-HMC
# (Q_BNN_STEPS of 30,000 in chunks of Q_BNN_CHUNK) at scale="paper";
# ess_msjd's trace="all" on the fused kernel at n = 100,000, P in {8, 512}
# (Q_ESS_STEPS of 1,000,000, burn-in Q_ESS_BURN of 2000); and the summary.
# 17d: profile_smallp_torch at its defaults (P = 4, n = 500, 2000
# supersteps)
P17_TIMEOUT_S, P17_QUEUE_S, P17_Z = 300, 900, 4.0
BANANA_MEAN, BANANA_SD = (0.0, -8.0), (1.0, 3.0)
ZOO_MNIST_STEPS = 200
Q_LSTM_STEPS, Q_LSTM_CHUNK, Q_LSTM_PRETRAIN = 300, 100, 5
Q_KILL_DELAY_S = 0.1
Q_CIFAR_STEPS, Q_CIFAR_CHUNK, Q_CIFAR_PRETRAIN = 6, 2, 3
Q_BNN_STEPS, Q_BNN_CHUNK = 30, 10
Q_ESS_STEPS, Q_ESS_BURN = 5000, 500

# phase 6's P sweeps on the benchmark cell's data: one SWEEP_STEPS-superstep
# launch per (N, depth), each timed over SWEEP_REPS, emit="all" up to its
# 512-lane cap.  binary: depths 1-10 (all 1-9); flat MP: P = 4 ... 1024
# (all ... 512); general: N = 3 at depths 1-5 (all 1-4) and N = 7 at 1-3
# (depth 1 is the flat-MP kernel at P = N + 1)
SWEEP_SHAPES = {
    "binary": [(1, d) for d in range(1, 11)],
    "mp": [(2**k - 1, 1) for k in range(2, 11)],
    "general": [(3, d) for d in range(1, 6)] + [(7, d) for d in range(1, 4)],
}
SWEEP_STEPS = 1000
SWEEP_REPS = 5
# phase 6's phase clocks (the stamped library): (mode, emit, N, depth) of
# mp root P = 1024 and all P = 512, general 7 x 3 root and all, binary root
# P = 1024 and all P = 512, and, where a superstep is one dependent chain's
# latency, binary, mp and general root at P = 8, 8 and 16; one
# SWEEP_STEPS-superstep launch each
STAMP_CELLS = (("mp", "root", 1023, 1), ("mp", "all", 511, 1),
               ("general", "root", 7, 3), ("general", "all", 7, 3),
               ("binary", "root", 1, 10), ("binary", "all", 1, 9),
               ("binary", "root", 1, 3), ("mp", "root", 7, 1),
               ("general", "root", 3, 2))
# a chain kernel's instantiation in a mangled name: its mode, kAll and, for
# the general kernel, its depth
CHAIN_KERNEL = re.compile(
    r"chain_(binary|mp|general)_kernelILb([01])E(?:Li(\d+)E)?")
TREE_KERNEL = re.compile(r"tree_(positions|select|gather)_kernel")
SSD_KERNEL = re.compile(r"mamba2_ssd_kernelI(f|13__nv_bfloat16)E")
SSD_DTYPE = {"f": "float", "13__nv_bfloat16": "bf16"}


class Phase:
    """Prints the phase's wall time when it ends, failed or not."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"== {self.name}", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "FAILED" if exc_type else "ok"
        print(f"== {self.name}: {status}, {dt:.3f} s wall", flush=True)
        return False


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def run_tool(cmd: list[str]) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=30)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr}")
    return res.stdout.strip()


def event_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean ms of fn() on the card over ``reps`` calls, after one warm-up
    unless ``warmup`` is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chain_sm_bound(mode: str, emit: str, P: int, steps: int, n_data: int,
                   *, N: int = 1, depth: int = 1, rng: str = "kernel",
                   chains: int = 1) -> dict:
    """The least time of one fused_chain launch of ``steps`` supersteps
    over ``n_data`` points.

    A chain is one block, and a block lives on one SM, so a chain's issue
    work meets one SM's rates, not the whole card's; a farm of C chains
    runs ceil(C / 132) waves of one chain each per SM.  The floor is the
    largest of three times over the launch, each fixed by the random
    stream and the math, not by the kernel's design:

    - ``imad``: Philox4x32-10's PHILOX_MULS = 40 multiplies a call at
      IMAD_PER_CLOCK = 64 a clock on the chain's SM.  emit="root" draws 2
      calls per node (u1, u2) and 1 per superstep (usel): 80 P + 40
      multiplies a superstep; emit="all" adds the slot uniform, 1 call per
      node: 120 P + 40.  With injected uniforms (``rng="input"``) there
      are none; the uniforms count as bytes instead.
    - ``mufu``: multi-function results at MUFU_PER_CLOCK = 16 a clock on
      the chain's SM.  Per node: Box-Muller's 3 x (log, sqrt, cos) 9, the
      log-density's log 1, the weight's exp 1.  The walk: binary 2 per
      sibling pair (the exp and the log1p of its softplus), 2 (P - 1); mp
      none (its log-sum-exp shifts every logA alike and cancels in the
      weights exp(lw - max lw)); general per level i the exp of each of
      the base^(i+1) level nodes and the log of each of the base^i group
      totals.  Divisions are not counted (a
      constant's reciprocal is one result a launch, and the log-density's
      is left out of the floor).
    - ``bytes``: the data's x and y read once (2 n floats, what the
      statistics pass needs; not the padded grid), and per chain its seed
      and states (7 floats) and what each superstep writes (the trace's 4
      floats, emit="all" 8 and the P emitted b0) and, with injected
      uniforms, reads (6 floats a node and usel, emit="all" 1 more a
      node), at the whole card's memory rate PEAK_BYTES_PER_S: a floor,
      since no share of the card moves bytes faster, though one SM alone
      draws less.

    Returns the bound in ms, ``bound_by`` (the largest term: "imad",
    "mufu" or "bytes") and each term's ms.
    """
    base = N + 1 if mode != "binary" else 2
    all_ = emit == "all"
    calls = (3 if all_ else 2) * P + 1
    if mode == "binary":
        walk = 2 * (P - 1)
    elif mode == "mp":
        walk = 0
    else:
        walk = sum(base ** (i + 1) + base**i for i in range(depth))
    clocks = {
        "imad": (0.0 if rng == "input" else
                 calls * PHILOX_MULS / IMAD_PER_CLOCK),
        "mufu": (11 * P + walk) / MUFU_PER_CLOCK,
    }
    waves = -(-chains // SM_COUNT)
    ms = {k: waves * steps * c / SM_CLOCK_HZ * 1e3 for k, c in clocks.items()}
    step_floats = ((8 + P) if all_ else 4) + (
        ((7 if all_ else 6) * P + 1) if rng == "input" else 0)
    nbytes = 4.0 * (2 * n_data + chains * (7 + steps * step_floats))
    ms["bytes"] = nbytes / PEAK_BYTES_PER_S * 1e3
    by = max(ms, key=ms.get)
    return {"bound_ms": ms[by], "bound_by": by, "ms": ms}


def lstm_fused_bound(P: int = 8, B: int = 60_000, T: int = 28, F: int = 28,
                     H: int = 64) -> dict:
    """The bound of lstm_fused (pmpx/kernels/lstm_fused.py) at the
    MNIST-LSTM protocol's shapes: P = 8 parameter sets (N = 7, a binary
    tree of 8 states), the full batch B = 60,000, T = F = 28, H = 64
    (lstm_final_hidden, lstm_fused.py:83-115).  8 H (F + H) T flops per
    parameter set and example (the two gate matmuls); bytes: x (T, B, F)
    read once, the P weight sets read once, (P, B, H) written, all f32.
    Against f32 on the CUDA cores (the route before the tensor cores), as
    3xTF32 (three TF32 products) on the tensor cores (495 TFLOP/s), and
    against bf16 inputs (x, Wx, Wh; the bias and h_T stay f32) on the
    tensor cores (989 TFLOP/s).  The transcendental floor: the cell
    update's LSTM_MUFU_PER_CELL multi-function-unit results per (row,
    unit, step) at MUFU_PER_S.  ``bound_ms`` and ``bound_ms_bf16`` are the
    least times of the kernel's own routes: the larger of their product's
    bound and the transcendental floor."""
    flops = 8.0 * H * (F + H) * T * P * B
    wide = T * B * F + P * (F * 4 * H + H * 4 * H)
    narrow = P * 4 * H + P * B * H
    nbytes = 4.0 * (wide + narrow)
    b_ms, b_by = bound(flops, nbytes)
    ms_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    ms_3xtf32 = 3.0 * flops / PEAK_TF32_FLOPS * 1e3
    ms_bf16 = max(flops / PEAK_BF16_FLOPS * 1e3,
                  (2.0 * wide + 4.0 * narrow) / PEAK_BYTES_PER_S * 1e3)
    ms_mufu = LSTM_MUFU_PER_CELL * P * B * H * T / MUFU_PER_S * 1e3
    return {"P": P, "B": B, "flops": flops, "bytes": nbytes,
            "bound_ms_f32": b_ms, "bound_by_f32": b_by,
            "bound_ms_3xtf32": ms_3xtf32, "bound_ms_bf16_tensor": ms_bf16,
            "transcendental_floor_ms": ms_mufu,
            "bound_ms": max(ms_3xtf32, ms_mufu, ms_bytes),
            "bound_ms_bf16": max(ms_bf16, ms_mufu)}


def lstm_sass_mma(so: Path) -> dict:
    """The tensor-core instructions in each instantiation of
    lstm_fused_kernel, counted in ``cuobjdump -sass`` of the built library:
    HMMA (mma.sync) and HGMMA (Hopper's wgmma), {"float" | "bfloat16":
    {"hmma": n, "hgmma": m, "opcodes": [...]}}."""
    from pmpx_torch import _build

    tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr}")
    tags = (("float", "lstm_fused_kernelIfE"),
            ("bfloat16", "lstm_fused_kernelI13__nv_bfloat16E"))
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = next((tag for tag, m in tags if m in line), None)
            if fn:
                counts[fn] = {"hmma": 0, "hgmma": 0, "opcodes": set()}
            continue
        for op in ("HGMMA", "HMMA"):
            if fn and f" {op}." in line:
                counts[fn][op.lower()] += 1
                counts[fn]["opcodes"].add(
                    op + line.split(f" {op}", 1)[1].split()[0])
                break
    return {k: {**v, "opcodes": sorted(v["opcodes"])}
            for k, v in counts.items()}


def ptxas_usage(log: str) -> dict:
    """Registers and static shared memory that ``ptxas -v`` reported for
    each chain kernel instantiation (CHAIN_KERNEL), under a readable label
    such as ``chain_general_kernel<true, 3>``, for each tree kernel
    (TREE_KERNEL) and for each instantiation of the SSD scan (SSD_KERNEL,
    ``mamba2_ssd_kernel<float>`` and ``<bf16>``): {label: {"registers":
    r, "smem_bytes": s}}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = CHAIN_KERNEL.search(m.group(1))
            t = TREE_KERNEL.search(m.group(1))
            ssd = SSD_KERNEL.search(m.group(1))
            fn = t.group(0) if t else None if k is None else (
                f"chain_{k.group(1)}_kernel<{('false', 'true')[int(k.group(2))]}"
                + (f", {k.group(3)}>" if k.group(3) else ">"))
            if ssd:
                fn = f"mamba2_ssd_kernel<{SSD_DTYPE[ssd.group(1)]}>"
        elif fn and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out[fn] = {"registers": int(regs.group(1)) if regs else None,
                       "smem_bytes": int(smem.group(1)) if smem else 0}
            fn = None
    return dict(sorted(out.items()))


def chain_p_sweep(target, theta, seed) -> dict:
    """Each chain kernel's time per superstep against P on ``target``: one
    SWEEP_STEPS-superstep launch per SWEEP_SHAPES entry and emit (emit="all"
    up to its 512-lane cap), in-kernel Philox, step 0.02, transition sigma
    1, each timed over SWEEP_REPS launches, beside :func:`chain_sm_bound`.
    A linear fit of µs per superstep against P per series (binary and flat
    MP per emit, general per N and emit): the intercept is the latency
    floor of a superstep, the slope what one more node's instructions
    cost."""
    from pmpx_torch.kernels import fused_chain as fc

    rows = []
    for family, shapes in SWEEP_SHAPES.items():
        for emit in ("root", "all"):
            for N, d in shapes:
                P_d = (N + 1) ** d
                if emit == "all" and fc.lane_extent(P_d) > fc.EMIT_MAX_L:
                    continue
                mode = "binary" if N == 1 else "mp" if d == 1 else "general"
                kw = dict(P=P_d, depth=d, n_data=float(target.n),
                          temper=float(target.temper), step_size=0.02,
                          mode=mode, N=N)

                def run(emit=emit, kw=kw):
                    return fc.chain_chunk(target.x2d, target.y2d, theta,
                                          steps=SWEEP_STEPS, seed=seed,
                                          emit=emit, **kw)

                cb = chain_sm_bound(mode, emit, P_d, SWEEP_STEPS, target.n,
                                    N=N, depth=d)
                row = {"series": family, "mode": mode, "emit": emit, "N": N,
                       "depth": d, "P": P_d,
                       "us": event_ms(run, SWEEP_REPS) * 1e3 / SWEEP_STEPS,
                       "bound_us": cb["bound_ms"] * 1e3 / SWEEP_STEPS,
                       "bound_by": cb["bound_by"]}
                rows.append(row)
                print(f"P sweep {family} {emit} N={N} depth={d} P={P_d}: "
                      f"{row['us']:.6g} µs per superstep (bound "
                      f"{row['bound_us']:.6g}, {row['bound_by']})")
    fits = {}
    for r in rows:
        key = (f"{r['series']} {r['emit']}" if r["series"] != "general"
               else f"general N={r['N']} {r['emit']}")
        fits.setdefault(key, []).append(r)
    for key, sel in fits.items():
        slope, icpt = np.polyfit([r["P"] for r in sel],
                                 [r["us"] for r in sel], 1)
        fits[key] = {"intercept_us": float(icpt),
                     "ns_per_node": float(slope) * 1e3}
    return {"rows": rows, "fits": fits}


def stamp_splits(target, theta, seed) -> list[dict]:
    """Where a superstep's clocks go, phase by phase, for each STAMP_CELLS
    entry: one SWEEP_STEPS-superstep launch from the stamped library
    (thread 0 of the block laps the SM clock at each phase boundary), its
    clocks per superstep and shares, beside the default library's and the
    stamped library's times of the same launch.  The stamped launch's
    trace must be bit-equal to the default one's.  Not table times: the
    laps cost a few instructions each."""
    from pmpx_torch.kernels import fused_chain as fc

    out = []
    dev = theta.device
    for mode, emit, N, d in STAMP_CELLS:
        kw = dict(P=(N + 1) ** d, depth=d, n_data=float(target.n),
                  temper=float(target.temper), step_size=0.02, mode=mode,
                  N=N, emit=emit)
        buf = torch.zeros(len(fc.STAMP_PHASES), dtype=torch.int64,
                          device=dev)

        def run(stamps=None, kw=kw):
            return fc.chain_chunk(target.x2d, target.y2d, theta,
                                  steps=SWEEP_STEPS, seed=seed,
                                  stamps=stamps, **kw)

        plain_out, stamped_out = run(), run(buf)
        for a, b in zip(plain_out, stamped_out):
            require(torch.equal(a, b), f"stamped {mode} {emit} bit-equal "
                                       f"to the default library")
        split = fc.stamp_split(mode, buf, SWEEP_STEPS)
        total = sum(split.values())
        row = {"mode": mode, "emit": emit, "N": N, "depth": d,
               "P": kw["P"], "clocks_per_superstep": split,
               "total_clocks": total,
               "shares": {k: v / total for k, v in split.items()},
               "ms_default": event_ms(run, SWEEP_REPS),
               "ms_stamped": event_ms(lambda: run(buf), SWEEP_REPS)}
        out.append(row)
        print(f"stamps {mode} {emit} P={kw['P']}: {total:.6g} clocks per "
              f"superstep; " + ", ".join(
                  f"{k} {v:.6g} ({v / total:.3f})" for k, v in split.items()))
    return out


def chain_vs_plain(fc, label, target, theta0, consts, seed, steps=100,
                   chunks=2) -> float:
    """``chunks`` launches of ``steps`` supersteps of fc.chain_chunk on
    injected uniforms, each superstep held against the plain version's
    from the kernel's own previous state (fc.replay_against_plain).
    Requires CHAIN_AGREE of the selections equal and the states within
    CHAIN_ATOL where they are; returns that max |err|."""
    dev = theta0.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    uin = 1.0 - torch.rand(
        (chunks, steps * fc.U_ROWS, fc.lane_extent(consts["P"])),
        generator=gen, device=dev)
    _, _, agree, err, misses = fc.replay_against_plain(
        target.x2d, target.y2d, theta0, uin, **consts)
    for t, k, kk, u, lo, hi in misses:
        print(f"step {t}: plain picks {k}, kernel {kk}; u = {u:.9g}, "
              f"plain cdf[k-1], cdf[k] = {lo:.9g}, {hi:.9g}")
    n_steps = steps * chunks
    print(f"{label} (P={consts['P']}): {agree}/{n_steps} selections agree; "
          f"max|err| of the state where they do: {err:.3g}")
    require(agree >= CHAIN_AGREE * n_steps, f"{label} selections")
    require(err <= CHAIN_ATOL, f"{label} trace atol")
    return err


def farm_vs_plain(fc, farm_mod, label, target, cfg, theta, seed) -> float:
    """One FARM_STEPS-superstep launch of a farm of len(theta) chains of
    cfg over ``target`` on injected uniforms, each chain replayed step by
    step against the plain version from its own states.  Requires one
    launch, CHAIN_AGREE of each chain's selections equal and the states
    within CHAIN_ATOL where they are; returns that max |err|."""
    from pmpx_torch.kernels import launches

    dev = theta.device
    C = theta.shape[0]
    kw = fc.chain_consts(target, cfg)
    farm = farm_mod.make_chain_farm_fused(target, cfg, FARM_STEPS,
                                          chunk=FARM_STEPS, rng="input")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    uin = 1.0 - torch.rand(
        (1, C, FARM_STEPS * fc.U_ROWS, fc.lane_extent(kw["P"])),
        generator=gen, device=dev)
    before = launches[fc.FARM_KERNEL]
    roots = farm(farm_mod.chain_generators(seed, C, dev), theta, uin=uin)
    require(launches[fc.FARM_KERNEL] == before + 1,
            f"{label}: the farm in one launch")
    worst = 0.0
    for c in range(C):
        agree, err, misses = fc.replay_roots_against_plain(
            target.x2d, target.y2d, theta[c], uin[0, c], roots[c], **kw)
        for t, k, kk, u, lo, hi in misses:
            print(f"{label} chain {c} step {t}: plain picks {k}, kernel "
                  f"{kk}; u = {u:.9g}, plain cdf[k-1], cdf[k] = "
                  f"{lo:.9g}, {hi:.9g}")
        print(f"{label} of {C}, chain {c} (P={kw['P']}): "
              f"{agree}/{FARM_STEPS} selections agree with the plain "
              f"version; max|err| of the state where they do: {err:.3g}")
        require(agree >= CHAIN_AGREE * FARM_STEPS,
                f"{label} chain {c} selections")
        require(err <= CHAIN_ATOL, f"{label} chain {c} trace atol")
        worst = max(worst, err)
    return worst


def tail_check(name, means, target, bench) -> dict:
    """Tail means of (b0[, b1]) within 4 posterior sd of the least-squares
    fit of ``target``'s data; returns the |z| by coordinate."""
    ls, sd = bench.least_squares(target)
    k = len(means)
    z = ((torch.tensor(means, dtype=torch.float64) - ls[:k]) / sd[:k]).abs()
    print(f"{name}: tail mean {list(means)}, least squares "
          f"{ls[:k].tolist()}, posterior sd {sd[:k].tolist()}, |z| "
          f"{z.tolist()}")
    require(all(math.isfinite(m) for m in means), f"{name}: finite means")
    require(bool((z < 4.0).all()), f"{name}: mean within 4 sd of the fit")
    return {"z": z.tolist()}


def posterior_check(name, trace, burn, target, bench) -> None:
    ls, sd = bench.least_squares(target)
    mean = trace[burn:, :2].double().mean(0).cpu()
    z = ((mean - ls) / sd).abs()
    print(f"{name}: posterior mean (b0, b1) = {mean.tolist()}, "
          f"least squares = {ls.tolist()}, posterior sd = {sd.tolist()}, "
          f"|z| = {z.tolist()}")
    require(bool(torch.isfinite(trace).all()), f"{name}: finite trace")
    require(bool((z < 4.0).all()), f"{name}: mean within 4 sd of the fit")


def hmc_density_calls(spec: dict) -> int:
    """value_and_grad_batch calls (one linreg_rss launch each on the
    sweep) in one superstep of an HMC spec: SP 1 + 2 a leapfrog step, MP 1
    + 2 N, PMP 1 + depth (each level's edges in one call)."""
    if spec["algo"] == "sp_hmc":
        return 1 + 2 * spec["num_leapfrog"]
    if spec["algo"] == "mp_hmc":
        return 1 + 2 * spec["N"]
    return 1 + spec["depth"]


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms(True)`` for one check, with
    ``warn_only``: an op on the path without a deterministic CUDA version
    warns instead of raising; yields the set of such ops torch named."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    flagged = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield flagged
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            for w in caught:
                msg = str(w.message)
                if "does not have a deterministic implementation" in msg:
                    flagged.add(msg.split(" does not have")[0].strip())
                elif "CuBLAS" in msg or "CUBLAS" in msg:
                    flagged.add("cuBLAS (CUBLAS_WORKSPACE_CONFIG unset)")


def resumed_gate(label, want: dict, got: dict, flagged: set) -> dict:
    """The resumed run's trace against the straight run's: bit-equal, or,
    where torch named an op on the path without a deterministic CUDA
    version, within RESUME_RTOL relative."""
    require(set(want) == set(got), f"{label}: the same trace keys")
    for k in want:
        require(want[k].shape == got[k].shape, f"{label}: {k} shape")
        require(bool(np.isfinite(want[k]).all()), f"{label}: {k} finite")
    equal = all(np.array_equal(want[k], got[k]) for k in want)
    gap = max(float(np.abs(want[k].astype(np.float64) - got[k]).max()
                    / max(float(np.abs(want[k]).max()), 1e-30))
              for k in want)
    if not equal:
        require(bool(flagged) and gap <= RESUME_RTOL,
                f"{label}: resumed trace bit-equal to the straight one "
                f"(relative gap {gap:.3g}; ops without a deterministic "
                f"version: {sorted(flagged)})")
    return {"bit_equal": equal, "max_rel_gap": gap,
            "nondeterministic_ops": sorted(flagged)}


def lstm_torch_state(post, theta) -> dict:
    """A torch ``nn.LSTM`` + ``nn.Linear`` state dict holding an MNIST-LSTM
    theta (the inverse of ``theta_from_torch_state``: the hidden-side bias
    as ``bias_ih_l0``, ``bias_hh_l0`` zero), for ``mnist.run``'s
    ``warm_start``."""
    p = {k: v.detach().cpu() for k, v in post.unravel(theta).items()}
    cell = "OptimizedLSTMCell_0"
    cat = lambda side, leaf, tr: torch.cat(  # noqa: E731
        [p[f"{cell}.{side}{g}.{leaf}"].T if tr else
         p[f"{cell}.{side}{g}.{leaf}"] for g in "ifgo"])
    b = cat("h", "bias", False)
    return {"lstm.weight_ih_l0": cat("i", "kernel", True),
            "lstm.weight_hh_l0": cat("h", "kernel", True),
            "lstm.bias_ih_l0": b, "lstm.bias_hh_l0": torch.zeros_like(b),
            "fc.weight": p["Dense_0.kernel"].T.contiguous(),
            "fc.bias": p["Dense_0.bias"]}


def tree_launches(n: int, gather: bool = False,
                  inplace: bool = False) -> dict:
    """The tree kernels' launches of n binary supersteps on the card
    (kernels/pmp_tree.py): one of each side of the target call (the
    positions over the innovations where the chains' columns reach
    INPLACE_COLUMNS), and the grid-wide gather where the emitted rows pass
    one block's copy."""
    out = {"pmp_tree_positions_inplace" if inplace else "pmp_tree_positions":
           n, "pmp_tree_select": n}
    if gather:
        out["pmp_tree_gather"] = n
    return out


def phase2b(dev, bench) -> list:
    """Phase 2b: the tree kernels against their plain versions (the torch
    functions, on the card) at TREE_CASES, on a log-density of a
    posterior's spread (weights of O(1-10), many that underflow in the
    softmax): Y bit-equal, log_accept within TREE_TOL, a draw or root
    different only where its uniform lies within TREE_TOL of a step of
    the plain CDF, a repeat bit-equal.  Returns phase 6's rows, one a
    kernel at the TREE_TIMED shapes: the card's ms a call (a CUDA graph of
    calls, bench.graph_us), the plain version's (eager, between CUDA
    events) and the bound (each byte read and written once at 3.35 TB/s;
    the arithmetic, ~10 flops a node, is far below it)."""
    from pmpx_torch.kernels import pmp_tree
    from pmpx_torch.resample import categorical_many
    from pmpx_torch.samplers import pmp
    from pmpx_torch.samplers.stabilize import stabilize_logits

    rows = {k: {"name": k, "route": "cuda",
                "source": "pmpx_torch/csrc/pmp_tree.cu",
                "replaces": None, "library_ms": None}
            for k in ("pmp_tree_positions", "pmp_tree_select")}
    for label, C, depth, d, selection, stabilizer in TREE_CASES:
        P = 1 << depth
        num = 1 if selection == "single" else P
        cfg = pmp.PMPConfig(N=1, depth=depth, step_size=0.02,
                            selection=selection, stabilizer=stabilizer)
        g = torch.Generator(device=dev)
        g.manual_seed(depth * 100 + C)
        theta = torch.randn((C, d), generator=g, device=dev)
        eps = torch.randn((C, P, d), generator=g, device=dev)
        Y = pmp_tree.tree_positions(theta, eps, depth, cfg.step_size)
        require(torch.equal(Y, pmp_tree.tree_positions_ref(
            theta, eps, depth, cfg.step_size)),
            f"2b {label}: Y bit-equal to tree_positions")
        logpi = -((Y - theta[:, None]) ** 2).sum(-1) * (3000.0 / d)
        u = torch.rand((C, num), generator=g, device=dev)
        pick = torch.randint(0, P, (C,), generator=g, device=dev)
        got = pmp_tree.tree_select(cfg, Y, logpi, u, pick)
        again = pmp_tree.tree_select(cfg, Y, logpi, u, pick)
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"2b {label}: a repeat bit-equal")
        theta2, samples, root, logA, root_logp = got
        want = pmp.log_accept_tree(Y, logpi, cfg.topology(),
                                   cfg.transition())
        la_err = (logA - want).abs().max().item()
        logits = stabilize_logits(want, stabilizer, cfg.nan_guard)
        cdf = torch.cumsum(torch.softmax(logits, -1), -1)
        cdf = cdf / cdf[:, -1:]
        pos = torch.searchsorted(cdf.contiguous(), u)
        below = torch.take_along_dim(cdf, (pos - 1).clamp(0, P - 1), -1)
        above = torch.take_along_dim(cdf, pos.clamp(0, P - 1), -1)
        near = torch.minimum((u - below).abs(), (u - above).abs()) < TREE_TOL
        draws = categorical_many(logits, num, u=u).long()
        same = (samples == torch.take_along_dim(
            Y, draws[..., None], dim=1)).all(-1)
        slot = (pick if selection == "all_uniform"
                else torch.zeros_like(pick))[:, None]
        roots = (root.long() == draws.gather(1, slot)[:, 0]) | near.gather(
            1, slot)[:, 0]
        chain = torch.arange(C, device=dev)
        print(f"2b {label}: C={C} P={P} d={d} {selection} {stabilizer}: "
              f"max|log_accept err| {la_err:.3g}; draws equal "
              f"{same.float().mean().item():.6f}, the rest near a step: "
              f"{bool((same | near).all())}; roots {int(roots.sum())}/{C}")
        require(la_err <= TREE_TOL, f"2b {label}: log_accept")
        require(bool((same | near).all()) and bool(roots.all()),
                f"2b {label}: draws and roots")
        require(torch.equal(theta2, Y[chain, root.long()])
                and torch.equal(root_logp, logpi[chain, root.long()]),
                f"2b {label}: the root's row and log-density")
        if label not in TREE_TIMED:
            continue
        rows_d = d if selection == "single" else (P + 1) * d
        for kname, call, plain, nbytes in (
                ("pmp_tree_positions",
                 lambda: pmp_tree.tree_positions(theta, eps, depth, 0.02),
                 lambda: pmp_tree.tree_positions_ref(theta, eps, depth, 0.02),
                 4 * C * (d + 2 * P * d)),
                ("pmp_tree_select",
                 lambda: pmp_tree.tree_select(cfg, Y, logpi, u, pick),
                 lambda: pmp_tree.tree_select_ref(
                     cfg, Y, logpi, u,
                     pick if selection == "all_uniform" else None),
                 4 * C * (2 * P + num + 2 + 2 * rows_d))):
            b_ms, b_by = bound(10.0 * C * P, nbytes)
            cell = {"ms": bench.graph_us(call) / 1e3,
                    "plain_ms": event_ms(plain, 20), "bound_ms": b_ms,
                    "bound_by": b_by, "C": C, "P": P, "d": d}
            print(f"{kname} at the {label} shape: {json.dumps(cell)}")
            rows[kname].update(cell if label == "sweep"
                               else {f"{label}_shape": cell})
            rows[kname]["max_abs_err"] = max(
                rows[kname].get("max_abs_err", 0.0),
                la_err if kname == "pmp_tree_select" else 0.0)
    return list(rows.values())


def phase2c(dev) -> dict:
    """Phase 2c: ``mamba2_ssd`` and the in-place ``tree_positions`` on the
    card at the granite cell's shapes against their plain versions
    (SSD_SHAPE within SSD_REL; P = 8 x GRANITE_D bit-equal), each timed
    (CUDA events) beside its bytes bound, and one superstep of the cell's
    program with its launches gated: a scan a Mamba layer, the positions
    over the innovations, the select and its gather.  Needs ~62 GB of the
    card's memory at once; returns the rows it printed."""
    import torch.nn.functional as F

    from pmpx_torch.kernels import launches, pmp_tree, reset_launches
    from pmpx_torch.kernels.mamba2_ssd import mamba2_ssd, ssd_chunked_ref

    def counts():
        return {k: v for k, v in launches.items() if v}

    rows = {}
    S, T, H, hd, N = SSD_SHAPE
    g = torch.Generator(device=dev)
    g.manual_seed(24)
    # x, B, C as views of one conv output, as the model gives them
    xbc = torch.randn((S, T, H * hd + 2 * N), generator=g,
                      device=dev).to(torch.bfloat16)
    x = xbc[..., :H * hd].reshape(S, T, H, hd)
    B, C = xbc[..., H * hd:H * hd + N], xbc[..., H * hd + N:]
    dt = F.softplus(torch.randn((S, T, H), generator=g, device=dev) - 3.0)
    A = -torch.exp(torch.rand((S, H), generator=g, device=dev) * 2.7)
    D = torch.randn((S, H), generator=g, device=dev)
    reset_launches()
    y = mamba2_ssd(x, dt, A, B, C, D)
    torch.cuda.synchronize()
    require(counts() == {"mamba2_ssd": 1}, f"2c mamba2_ssd: one launch, "
            f"{counts()}")
    want = ssd_chunked_ref(x, dt, A, B, C, D).float()
    got = y.float()
    scale = want.abs() + want.pow(2).mean().sqrt()
    rel = float(((got - want).abs() / scale).max())
    require(bool(torch.isfinite(got).all()) and rel < SSD_REL,
            f"2c mamba2_ssd within {SSD_REL:g} of its plain version: {rel}")
    nbytes = S * T * (2 * H * hd * 2 + 2 * N * 2 + H * 4)
    b_ms, b_by = bound(5.0 * hd * N * H * S * T, nbytes)
    rows["mamba2_ssd"] = {
        "ms": event_ms(lambda: mamba2_ssd(x, dt, A, B, C, D), 10),
        "plain_ms": event_ms(lambda: ssd_chunked_ref(x, dt, A, B, C, D), 2),
        "bound_ms": b_ms, "bound_by": b_by, "max_rel_err": rel,
        "shape": list(SSD_SHAPE)}
    print(f"2c mamba2_ssd: {json.dumps(rows['mamba2_ssd'])}")
    del xbc, x, B, C, dt, A, D, y, want, got, scale
    torch.cuda.empty_cache()

    P = 1 << GRANITE_DEPTH
    g.manual_seed(25)
    theta = torch.randn((1, GRANITE_D), generator=g, device=dev)
    drawn = g.get_state()
    eps = torch.randn((1, P, GRANITE_D), generator=g, device=dev)
    reset_launches()
    Y = pmp_tree.tree_positions(theta, eps, GRANITE_DEPTH, GRANITE_STEP,
                                overwrite=True)
    torch.cuda.synchronize()
    require(Y.data_ptr() == eps.data_ptr()
            and counts() == {"pmp_tree_positions_inplace": 1},
            f"2c the positions over the innovations, one launch: {counts()}")
    g.set_state(drawn)
    plain = torch.randn((1, P, GRANITE_D), generator=g, device=dev)
    pmp_tree.tree_positions_inplace_ref(theta, plain, GRANITE_DEPTH,
                                        GRANITE_STEP)
    require(torch.equal(Y, plain), "2c the in-place positions bit-equal to "
            "the plain version at P = 8, d = 772,160,448")
    del plain
    torch.cuda.empty_cache()
    b_ms, b_by = bound(GRANITE_DEPTH * P * GRANITE_D,
                       (2 * P + 1) * GRANITE_D * 4)
    rows["pmp_tree_positions_inplace"] = {
        "ms": event_ms(lambda: pmp_tree.tree_positions(
            theta, eps, GRANITE_DEPTH, GRANITE_STEP, overwrite=True), 3),
        "bound_ms": b_ms, "bound_by": b_by, "P": P, "d": GRANITE_D}
    print(f"2c pmp_tree_positions_inplace: "
          f"{json.dumps(rows['pmp_tree_positions_inplace'])}")
    del theta, eps, Y
    torch.cuda.empty_cache()

    from benchmark import harness as H

    cell = H.load_cell(GRANITE_CELL)
    model = cell.module("models", "granite_hybrid")
    inp = model.inputs(cell.config, 2**31 + 24, dev)
    superstep, theta0 = model.program_chain(cell.config, inp, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2**33 + 24)
    mamba = cell.config["layer_types"][:cell.config[
        "num_hidden_layers"]].count("mamba")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        theta, out = superstep(gen, theta0)
    torch.cuda.synchronize()
    got = counts()
    require(got == {"mamba2_ssd": mamba, "pmp_tree_positions_inplace": 1,
                    "pmp_tree_select": 1, "pmp_tree_gather": 1},
            f"2c a granite superstep: a scan a Mamba layer and the tree's "
            f"in-place kernels: {got}")
    require(bool(torch.isfinite(theta).all())
            and math.isfinite(float(out["root_logp"])),
            "2c a granite superstep: a finite state and root_logp")
    rows["granite_superstep"] = {"launches": got,
                                 "peak_bytes":
                                     torch.cuda.max_memory_allocated()}
    print(f"2c granite superstep: {json.dumps(rows['granite_superstep'])}")
    del superstep, theta0, theta, out, inp
    torch.cuda.empty_cache()
    return rows


def phase12(dev, name: str, smi: str, bench) -> dict:
    """Phase 12's runs and gates; returns its launches by kernel."""
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.experiments import bnn, cifar_hmc, resilience
    from pmpx_torch.experiments import mnist as mnist_mod
    from pmpx_torch.experiments.ess_msjd import ess_target
    from pmpx_torch.interop import load_torch_pickle, theta_from_torch_state
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.metrics.recorder import load_trace, reference_style_name
    from pmpx_torch.models import MnistLSTM
    from pmpx_torch.samplers.base import compile_chain
    from pmpx_torch.targets.linreg import BayesLinReg
    from pmpx_torch.targets.nn import NNPosterior
    from pmpx_torch.data import load_mnist

    p12 = {}

    def counted(label, fn):
        """fn() with the launches counted from 0 and added to the
        phase's; returns (fn's result, its counts, wall s)."""
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in launches.items() if v}
        for k, v in counts.items():
            p12[k] = p12.get(k, 0) + v
        return out, counts, wall

    # 12a: the HMC family over the linreg posterior on the sweep
    et = ess_target(ESS_N, device=dev)
    tgt = BayesLinReg(et.x, et.y, temper=et.temper, method="sweep",
                      device=dev)
    for label, spec, steps in HMC_LINREG:
        gen = torch.Generator(device=dev)
        gen.manual_seed(12)
        theta0 = torch.tensor([0.0, 0.0, 1.0], device=dev)
        chain = compile_chain(SamplerSpec(**spec).build(tgt), gen, theta0,
                              lambda th, o: th)
        with torch.no_grad():
            # the capture, outside the clock, from a generator of its own
            chain.run(torch.Generator(device=dev), theta0, 1)
            (_, tr), counts, wall = counted(
                label, lambda: chain.run(gen, theta0, steps))
        calls = hmc_density_calls(spec)
        require(counts == {"linreg_rss": calls * steps},
                f"12a {label}: one linreg_rss launch a density call: "
                f"{counts}")
        burn = steps // 3
        tail = tr[burn:].double().mean(0).cpu()
        z = tail_check(f"12a {label}", tuple(tail[:2].tolist()), tgt,
                       bench)
        require(bool(torch.isfinite(tr).all()), f"12a {label}: finite")
        print(json.dumps({"hmc_linreg": label, **spec, "supersteps": steps,
                          "burn_in": burn, "tail_mean": tail.tolist(),
                          **z, "linreg_rss_per_superstep": calls,
                          "ms_per_superstep": wall * 1e3 / steps,
                          "launches": counts, "device": name,
                          "power": smi}))

    # the recorder of ops without a deterministic CUDA version, on a
    # positive control: torch names histc
    with deterministic() as probe:
        torch.histc(torch.rand(64, device=dev))
    require(any("histc" in op for op in probe),
            f"deterministic() records the histc control: {probe}")

    with tempfile.TemporaryDirectory() as tmp:
        # 12b-c: cifar_hmc and bnn at the paper's widths, straight and
        # interrupted after the first chunk and resumed
        def straight_and_resumed(label, mod, stem, steps, chunk, **kw):
            one, cut = f"{tmp}/{label}/one", f"{tmp}/{label}/cut"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with deterministic() as flagged:
                out, counts, wall = counted(label, lambda: mod.run(
                    num_steps=steps, chunk_steps=chunk, out_dir=one,
                    device=dev, **kw))
                peak = torch.cuda.max_memory_allocated()
                counted(label, lambda: mod.run(
                    num_steps=chunk, chunk_steps=chunk, out_dir=cut,
                    device=dev, **kw))
                counted(label, lambda: mod.run(
                    num_steps=steps, chunk_steps=chunk, out_dir=cut,
                    resume=True, device=dev, **kw))
            gate = resumed_gate(label, load_trace(f"{one}/{stem}.npz"),
                                load_trace(f"{cut}/{stem}.npz"), flagged)
            for k in ("loss_first", "loss_last"):
                require(math.isfinite(out[k]), f"{label}: {k} finite")
            rec = {"run": label, **kw, "num_steps": steps,
                   "chunk_steps": chunk, **out, **gate,
                   "ms_per_superstep": out["steady_ms_per_superstep"],
                   "peak_gib": peak / 2**30, "straight_wall_s": wall,
                   "deterministic_algorithms": True, "device": name,
                   "power": smi}
            print(json.dumps(rec))
            return rec

        for algo in ("sp_hmc", "mp_hmc", "pmp_hmc"):
            straight_and_resumed(
                f"cifar_{algo}", cifar_hmc, f"cifar_{algo}", CIFAR_STEPS,
                CIFAR_CHUNK, algo=algo, N=7, step_size=0.1,
                mom_scale=0.0005, scale="paper")
        for algo, stem in (("pmp_hmc", "bnn_pmphmc_N3"),
                           ("sp_hmc", "bnn_sphmc")):
            rec = straight_and_resumed(
                f"bnn_{algo}", bnn, stem, BNN_STEPS, BNN_CHUNK, algo=algo,
                n=2, hidden=1024, scale="paper")
            require(0.0 <= rec["acc_last"] <= 1.0, f"bnn {algo}: accuracy")

        # 12d: the MNIST-LSTM PMP chain through lstm_fused, from one
        # pretrain's theta: one loop, checkpointed chunks, and an
        # interrupted run extended by resume (adopt_prefix_run)
        x_tr, y_tr, _, _ = load_mnist(60_000, 10_000, device=dev)
        post = NNPosterior(MnistLSTM(), x_tr, y_tr, temper=10.0, device=dev)
        theta_ws = mnist_mod.pretrain(post, 50)
        ws = f"{tmp}/lstm_ws.pkl"
        torch.save(lstm_torch_state(post, theta_ws), ws)
        require(torch.equal(theta_from_torch_state(
            post, load_torch_pickle(ws)), theta_ws),
            "12d: the warm start's torch state maps back bit-equal")
        del post, x_tr, y_tr
        kw = dict(model="LSTM", algo="pmp", N=7, scale="paper",
                  lstm_kernel=True, warm_start=ws, device=dev)
        losses, lstm_runs = {}, {}
        for label, steps, chunk, extra in (
                ("one_loop", LSTM_CKPT_STEPS, 0, {}),
                ("chunked", LSTM_CKPT_STEPS, LSTM_CKPT_CHUNK, {}),
                ("interrupted", LSTM_CKPT_CHUNK, LSTM_CKPT_CHUNK, {}),
                ("resumed", LSTM_CKPT_STEPS, LSTM_CKPT_CHUNK,
                 {"resume": True})):
            # the interrupted run and its resume share a directory
            d = f"{tmp}/lstm/" + {"interrupted": "cut", "resumed": "cut"}.get(
                label, label)
            out, counts, wall = counted(f"12d {label}", lambda: mnist_mod.run(
                num_steps=steps, chunk_steps=chunk, out_dir=d, **kw, **extra))
            ran = steps - (LSTM_CKPT_CHUNK if label == "resumed" else 0)
            require(counts == {"lstm_fused": ran, **tree_launches(ran)},
                    f"12d {label}: one lstm_fused launch and one of each "
                    f"tree kernel a superstep: {counts}")
            stem = reference_style_name("PMP", 1e-4, steps, model="LSTM",
                                        N=7)
            losses[label] = load_trace(f"{d}/{stem}.npz")["loss"]
            lstm_runs[label] = {"wall_s": wall, "launches": counts, **out}
        for label in ("chunked", "resumed"):
            require(np.array_equal(losses[label], losses["one_loop"]),
                    f"12d {label}: the losses bit-equal to the one loop")
        require(bool(np.isfinite(losses["one_loop"]).all()), "12d finite")
        print(json.dumps({"mnist_lstm_checkpointed": lstm_runs,
                          "bit_equal": True, "device": name, "power": smi}))

        # 12e: resilience on the card, SIGKILLed child processes
        res, _, wall = counted("12e", lambda: resilience.run(
            num_steps=RES_STEPS, checkpoint_every=RES_EVERY,
            kills=RES_KILLS, n_data=ESS_N, depth=RES_DEPTH,
            throttle_ms=RES_THROTTLE_MS, kill_mode="sigkill",
            out_dir=f"{tmp}/resilience", device=dev))
        require(res["bitwise_identical"] and res["rows"] == RES_STEPS,
                "12e: the crash-looped trace bitwise identical")
        require(res["kills"] == RES_KILLS, f"12e: {RES_KILLS} kills")
        child = res["uninterrupted_launches"]
        require(child == {"linreg_rss": RES_STEPS,
                          **tree_launches(RES_STEPS)},
                f"12e: the child's superstep launched linreg_rss and the "
                f"tree kernels: {child}")
        for k, v in child.items():
            p12[k] = p12.get(k, 0) + v
        print(json.dumps({"resilience": res, "wall_s": wall,
                          "device": name, "power": smi}))

    print(json.dumps({
        "phase12_reduced": [
            f"cifar_hmc num_steps {CIFAR_STEPS} in chunks of {CIFAR_CHUNK} "
            "(the paper's 50,000)",
            f"bnn num_steps {BNN_STEPS} in chunks of {BNN_CHUNK} (the "
            "paper's 30,000 in chunks of 1000)",
            f"mnist LSTM num_steps {LSTM_CKPT_STEPS} in chunks of "
            f"{LSTM_CKPT_CHUNK} (the paper's 1,000,000)",
            f"resilience num_steps {RES_STEPS}, checkpoint_every "
            f"{RES_EVERY}, {RES_KILLS} kills (scale='paper': 1,000,000, "
            "100,000, 3)",
            "12a step counts "
            + ", ".join(f"{lb} {n}" for lb, _, n in HMC_LINREG),
        ], "launches": p12}))
    return p12


def phase13(dev, name: str, smi: str) -> dict:
    """Phase 13's runs and gates (the MNIST CNN, the packed layouts,
    nn_perf, profiling and the CLI's doctor); returns its launches by
    kernel (none is expected: the CNN and the packed layouts run cuDNN's
    and cuBLAS's kernels)."""
    from pmpx_torch import profiling
    from pmpx_torch.data import load_cifar10, load_mnist
    from pmpx_torch.experiments import cifar_hmc, nn_perf
    from pmpx_torch.experiments import mnist as mnist_mod
    from pmpx_torch.kernels import cnn_fast, launches, reset_launches
    from pmpx_torch.metrics.recorder import load_trace, reference_style_name
    from pmpx_torch.models import LeNet, MnistCNN, PackedLeNet
    from pmpx_torch.samplers.base import compile_chain
    from pmpx_torch.targets.nn import NNPosterior

    p13 = {}
    torch.backends.cudnn.benchmark = False

    def counted(fn):
        """fn() with the launches counted from 0 and added to the
        phase's, and the card's peak memory; returns (fn's result, wall s,
        peak GiB)."""
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for k, v in launches.items():
            if v:
                p13[k] = p13.get(k, 0) + v
        return out, wall, torch.cuda.max_memory_allocated() / 2**30

    with deterministic() as flagged, tempfile.TemporaryDirectory() as tmp:
        # 13a: the cnn_fast density at the warm start (run()'s Adam
        # pretrain) against the generic path's, one and P = 8 states
        x_tr, y_tr, _, _ = load_mnist(60_000, 10_000, device=dev)
        post = NNPosterior(MnistCNN(), x_tr, y_tr, temper=10.0, device=dev)
        th_ws = mnist_mod.pretrain(post, 50)
        g = torch.Generator(device=dev)
        g.manual_seed(13)
        Theta = th_ws + 1e-4 * torch.randn((8, post.d), generator=g,
                                           device=dev)
        with torch.no_grad():
            generic = post.log_prob_batch(Theta)
            one = post.log_prob(th_ws)
            cnn_fast.attach(post)
            fast = post.log_prob_batch(Theta)
            fast_one = post.log_prob(th_ws)
        rel = float(((fast - generic).abs() / generic.abs()).max())
        rel_one = abs(float(fast_one) - float(one)) / abs(float(one))
        print(json.dumps({"cnn_fast_warm_start": {
            "generic": generic.tolist(), "cnn_fast": fast.tolist(),
            "max_rel": rel, "log_prob_rel": rel_one, "rtol": CNN_FAST_RTOL},
            "device": name}))
        require(rel <= CNN_FAST_RTOL and rel_one <= CNN_FAST_RTOL,
                f"13a: cnn_fast within rtol {CNN_FAST_RTOL} of the generic "
                f"path at the warm start ({rel:.3g}, {rel_one:.3g})")
        del post, x_tr, y_tr, Theta

        # 13a: MH, MP and PMP on the generic path, PMP through cnn_fast,
        # each in checkpointed chunks; the kernel-path PMP run again,
        # interrupted after its first chunk and resumed
        cnn_runs = {}
        for label, algo, kern, steps, extra, sub in (
                ("mh", "mh", False, CNN_STEPS, {}, "mh"),
                ("mp", "mp", False, CNN_STEPS, {}, "mp"),
                ("pmp", "pmp", False, CNN_STEPS, {}, "pmp"),
                ("pmp_cnn_fast", "pmp", True, CNN_STEPS, {}, "fast"),
                ("pmp_cnn_fast_interrupted", "pmp", True, CNN_CHUNK, {},
                 "cut"),
                ("pmp_cnn_fast_resumed", "pmp", True, CNN_STEPS,
                 {"resume": True}, "cut")):
            out, wall, peak = counted(lambda: mnist_mod.run(
                model="CNN", algo=algo, N=7, scale="paper", num_steps=steps,
                chunk_steps=CNN_CHUNK, cnn_kernel=kern,
                out_dir=f"{tmp}/cnn/{sub}", device=dev, **extra))
            stem = reference_style_name(algo.upper(), 1e-4, steps,
                                        model="CNN", N=7)
            trace = load_trace(f"{tmp}/cnn/{sub}/{stem}.npz")
            require(bool(np.isfinite(trace["loss"]).all()),
                    f"13a {label}: finite losses")
            rec = {"cnn": label, "algo": algo, "N": 7, "cnn_kernel": kern,
                   **out, "num_steps": steps, "chunk_steps": CNN_CHUNK,
                   "peak_gib": peak, "wall_s": wall, "n_train": 60_000,
                   "n_test": 10_000, "device": name, "power": smi}
            rec["distinct_losses"] = int(np.unique(trace["loss"]).size)
            if "steady_ms_per_superstep" in out:  # two chunks or more ran
                rec["ms_per_superstep"] = out["steady_ms_per_superstep"]
            if algo != "mh":  # MH at temper 1000 may stay a while
                require(rec["distinct_losses"] > 1,
                        f"13a {label}: the chain moved")
            cnn_runs[label] = trace
            print(json.dumps(rec))
        gate = resumed_gate("13a pmp cnn_fast resumed",
                            cnn_runs["pmp_cnn_fast"],
                            cnn_runs["pmp_cnn_fast_resumed"], flagged)
        print(json.dumps({"cnn_resume": gate, "device": name}))

        # 13b: the packed LeNet against the nhwc one at theta0, then the
        # packed cifar_hmc's SP-HMC supersteps
        xc, yc, _, _ = load_cifar10(50_000, 10_000, device=dev)
        nhwc = NNPosterior(LeNet(), xc, yc, device=dev)
        packed = NNPosterior(PackedLeNet(), xc, yc, device=dev)
        theta0 = nhwc.init_theta()
        require(torch.equal(packed.init_theta(), theta0),
                "13b: the packed LeNet shares LeNet's theta0")
        with torch.no_grad():
            nv, ng = nhwc.value_and_grad_batch(theta0[None])
            (pv, pg), wall_pk, peak_pk = counted(
                lambda: packed.value_and_grad_batch(theta0[None]))
        v_rel = float((pv - nv).abs().max() / nv.abs().max())
        g_err = float((pg - ng).abs().max() / ng.abs().max())
        print(json.dumps({"packed_lenet_vs_nhwc": {
            "value_rel": v_rel, "grad_err_over_max": g_err,
            "value": nv.tolist(), "packed_grad_wall_s": wall_pk,
            "packed_grad_peak_gib": peak_pk}, "device": name}))
        require(v_rel <= PACKED_VAL_RTOL and g_err <= PACKED_GRAD_TOL,
                f"13b: packed LeNet's value and gradient at theta0 "
                f"({v_rel:.3g}, {g_err:.3g})")
        del nhwc, packed, xc, yc, nv, ng, pv, pg
        torch.cuda.empty_cache()
        out, wall, peak = counted(lambda: cifar_hmc.run(
            algo="sp_hmc", layout="packed", scale="paper",
            num_steps=PACKED_STEPS, chunk_steps=PACKED_CHUNK,
            pretrain_steps=PACKED_PRETRAIN,
            out_dir=f"{tmp}/cifar_packed", device=dev))
        for k in ("loss_first", "loss_last"):
            require(math.isfinite(out[k]), f"13b packed cifar: {k} finite")
        print(json.dumps({"cifar_packed": "sp_hmc", **out,
                          "ms_per_superstep": out["steady_ms_per_superstep"],
                          "num_steps": PACKED_STEPS,
                          "chunk_steps": PACKED_CHUNK, "peak_gib": peak,
                          "wall_s": wall, "device": name, "power": smi}))

        # 13c: nn_perf's CNN cells at full batch, footprint, bf16_delta
        table, wall, peak = counted(lambda: nn_perf.run(
            mode="table", only="mnist_CNN_*", iters=NNPERF_ITERS,
            out_dir=tmp, device=dev))
        cells = table["us_per_superstep"]
        require(len(cells) == 6 and all(isinstance(v, float) and v > 0
                                        for v in cells.values()),
                f"13c: every CNN cell of nn_perf's table timed: {cells}")
        print(json.dumps({"nn_perf_table": cells, "iters": NNPERF_ITERS,
                          "n_mnist": 60_000, "wall_s": wall,
                          "peak_gib": peak, "device": name, "power": smi}))
        foot, wall, _ = counted(lambda: nn_perf.footprint(
            P=FOOTPRINT_P, n_train=50_000, device=dev))
        variants = {k: v for k, v in foot.items()
                    if k.startswith("lenet_grad_")}
        variants.update({f"quarter_{k}": v for k, v in foot["quarter"].items()
                         if k.startswith("lenet_grad_")})
        require(len(variants) == 9 and all(
            not v.get("oom") and v.get("peak_gib", 0) > 0
            for v in variants.values()),
            f"13c: every footprint variant reports a peak: {variants}")
        print(json.dumps({"nn_perf_footprint": foot, "wall_s": wall,
                          "power": smi}))
        delta, wall, _ = counted(lambda: nn_perf.bf16_delta(
            iters=BF16_ITERS, only="mnist_CNN_*", device=dev))
        require(len(delta) == 3 and all("error" not in c
                                        for c in delta.values()),
                f"13c: bf16_delta's CNN cells: {delta}")
        print(json.dumps({"nn_perf_bf16_delta": delta, "iters": BF16_ITERS,
                          "wall_s": wall, "device": name}))

        # a trace of TRACE_STEPS CNN PMP supersteps on the generic path
        x_tr, y_tr, _, _ = load_mnist(60_000, 10_000, device=dev)
        post = NNPosterior(MnistCNN(), x_tr, y_tr, temper=10.0, device=dev)
        sup = mnist_mod.sampler_spec("pmp", 1e-4, 7).build(post)
        g.manual_seed(1)
        theta = post.init_theta()
        with torch.no_grad():
            # the first run, the capture, outside the trace
            chain = compile_chain(sup, g, theta)
            chain.run(g, theta, 1)
            torch.cuda.synchronize()
            with profiling.trace(f"{tmp}/trace"):
                t0 = time.perf_counter()
                chain.run(g, theta, TRACE_STEPS)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            del chain  # its graphs and their pool
        kern = profiling.device_time_us(f"{tmp}/trace")
        # the same supersteps with deterministic algorithms off, captured
        # anew (a graph replays the kernels chosen at its capture)
        torch.use_deterministic_algorithms(False)
        with torch.no_grad():
            chain = compile_chain(sup, g, theta)
            chain.run(g, theta, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain.run(g, theta, TRACE_STEPS)
            torch.cuda.synchronize()
            free_us = (time.perf_counter() - t0) * 1e6
            del chain
        torch.use_deterministic_algorithms(True, warn_only=True)
        conv = {k: v for k, v in kern.items() if re.search(
            r"conv|fprop|dgrad|wgrad|cudnn", k, re.I)}
        gemm = {k: v for k, v in kern.items()
                if "gemm" in k.lower() and k not in conv}
        total = sum(kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({"cnn_trace": {
            "supersteps": TRACE_STEPS, "kernel_us_total": total,
            "window_us": window_us, "idle_share": 1 - total / window_us,
            "ms_per_superstep_deterministic": window_us / TRACE_STEPS / 1e3,
            "ms_per_superstep_not_deterministic":
                free_us / TRACE_STEPS / 1e3,
            "conv_us": sum(conv.values()), "gemm_us": sum(gemm.values()),
            "kernels": len(kern),
            "top": [{"kernel": k[:90], "us": v, "share": v / total}
                    for k, v in top]}, "device": name}))
        require(total > 0 and conv and gemm,
                "13c: the trace's kernel time names conv and GEMM kernels")
        del post, x_tr, y_tr

    # 13d: the CLI's doctor names the card
    res = subprocess.run([sys.executable, "-m", "pmpx_torch.cli", "doctor",
                          "--probe-timeout", "120"], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent)
    report = json.loads(res.stdout[res.stdout.index("{"):])
    print(json.dumps({"doctor": report, "rc": res.returncode}))
    require(res.returncode == 0 and report["device"]["ok"]
            and report["device"]["device_kind"] == name,
            f"13d: doctor exits 0 and names the card: {res.stderr[-300:]}")

    print(json.dumps({
        "phase13_reduced": [
            f"mnist CNN num_steps {CNN_STEPS} in chunks of {CNN_CHUNK} (the "
            "paper's 250,000 in chunks of 250)",
            f"cifar_hmc packed SP-HMC num_steps {PACKED_STEPS} in chunks of "
            f"{PACKED_CHUNK} (the paper's 50,000), pretrain_steps "
            f"{PACKED_PRETRAIN} (cifar_hmc's 30)",
            f"nn_perf table iters {NNPERF_ITERS} (pmpx's 20), footprint P = "
            f"{FOOTPRINT_P} (pmpx's 8), bf16_delta iters {BF16_ITERS} "
            "(pmpx's 32)",
        ], "nondeterministic_ops": sorted(flagged), "launches": p13}))
    return p13


def phase14_inputs(dev, bench) -> dict:
    """Phase 14's target and inputs, made alike in every process from
    fixed seeds on the card: the benchmark cell's target and sampler,
    P14_CHAINS starting states, P proposals, one superstep's innovations
    and uniforms, and the farm row's binary P = 512 sampler."""
    from pmpx_torch.samplers import pmp

    cfg = bench.bench_config()
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    th = bench.theta0(dev)
    return {
        "target": bench.bench_target(dev),
        "cfg": cfg,
        "theta0": th + 0.05 * torch.randn((P14_CHAINS, 3), generator=g,
                                          device=dev),
        "Theta": th + 0.05 * torch.randn((cfg.P, 3), generator=g,
                                         device=dev),
        "eps": cfg.step_size * torch.randn((cfg.P, 3), generator=g,
                                           device=dev),
        "u": torch.rand((cfg.P,), generator=g, device=dev),
        "farm_cfg": pmp.PMPConfig(N=1, depth=9, step_size=cfg.step_size,
                                  selection="all_first"),
    }


def _roots(th, o):
    return th, o["root_index"]


def phase14_rank(rank, world, init_file, out_dir) -> None:
    """One rank of phase 14b, in a process of its own: a gloo world of
    ``world`` ranks (``file://`` init) that share the card.  Runs the data
    (data = world), tree (tree = world), chains (chains = world: the
    chain-batched superstep and the farm) and (chains 2 x data 2) meshes
    in that order, every rank alike; saves what it got to
    ``out_dir/rank{rank}.pt`` and prints its device, launches, collective
    routes and walls as one JSON line."""
    import datetime

    import torch.distributed as dist

    from pmpx_torch import bench
    from pmpx_torch import parallel as par
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.parallel import mesh as pm
    from pmpx_torch.samplers import pmp

    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=P14_JOIN_S))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    counts, walls = {}, {}

    def counted(label, fn):
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        for k, v in launches.items():
            if v:
                counts[k] = counts.get(k, 0) + v
        return out

    inp = phase14_inputs(dev, bench)
    target, cfg = inp["target"], inp["cfg"]
    n = target.n
    res = {}

    dmesh = pm.make_mesh(data=world)
    d, m = dmesh.get_local_rank(pm.AXIS_DATA), n // world
    sh = par.ShardedLinReg(target.x[d * m:(d + 1) * m],
                           target.y[d * m:(d + 1) * m], n,
                           temper=target.temper, mesh=dmesh)
    res["data_logp"] = counted(
        "data", lambda: sh.log_prob_batch(inp["Theta"])).cpu()

    tsup = par.make_tree_sharded_superstep(target, cfg,
                                           mesh=pm.make_mesh(tree=world))
    th, o = counted("tree", lambda: tsup(None, bench.theta0(dev),
                                         eps=inp["eps"], u=inp["u"]))
    res["tree"] = {"theta": th.cpu(), "log_accept": o["log_accept"].cpu()}

    cmesh = pm.make_mesh(chains=world)
    sup = pmp.make_superstep(target, cfg)
    _, recs = counted("chains", lambda: par.run_chains_sharded(
        sup, 14, inp["theta0"], P14_STEPS, cmesh, _roots, device=dev))
    res["chains"] = tuple(r.cpu() for r in recs)
    farm = par.make_chain_farm_fused(target, inp["farm_cfg"], FARM_STEPS,
                                     cmesh, chunk=FARM_STEPS)
    res["farm"] = counted("farm", lambda: farm(
        par.chain_generators(14, P14_CHAINS, dev), inp["theta0"])).cpu()

    m22 = pm.make_mesh(chains=2, data=2)

    def make_local(x_l, y_l):
        return pmp.make_superstep(par.ShardedLinReg(
            x_l, y_l, n, temper=target.temper, mesh=m22), cfg)

    th2 = bench.theta0(dev).repeat(2, 1)
    _, trace = counted("chains2_data2", lambda: par.run_chains_data_sharded(
        make_local, target.x, target.y, 15, th2, P14_DATA_STEPS, m22,
        collect=lambda t, o: t, device=dev))
    res["data_chains"] = trace.cpu()
    line = {"rank": rank, "current_device": torch.cuda.current_device(),
            "device": torch.cuda.get_device_name(dev), "launches": counts,
            "routes": pm.routes, "wall_s": walls}
    res["line"] = line
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    print(json.dumps(line), flush=True)
    dist.destroy_process_group()


def phase14(dev, name: str, smi: str, bench) -> dict:
    """Phase 14's runs and gates: 14a in this process on a one-rank NCCL
    mesh, 14b in P14_WORLD gloo ranks sharing the card; returns the
    sharded runs' launches by kernel (14a's and every rank's)."""
    import torch.distributed as dist

    from pmpx_torch import parallel as par
    from pmpx_torch.kernels import fused_chain as fc
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.parallel import mesh as pm
    from pmpx_torch.samplers import pmp

    p14 = {}

    def counted(fn):
        """fn() with the launches counted from 0 and added to the
        phase's; returns (fn's result, its counts)."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = {k: v for k, v in launches.items() if v}
        for k, v in counts.items():
            p14[k] = p14.get(k, 0) + v
        return out, counts

    def same(a, b) -> bool:
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, tuple):
            return len(a) == len(b) and all(map(same, a, b))
        return torch.equal(a, b)

    inp = phase14_inputs(dev, bench)
    target, cfg, th8 = inp["target"], inp["cfg"], inp["theta0"]
    th0 = bench.theta0(dev)
    sup = pmp.make_superstep(target, cfg)

    # 14a: a one-rank NCCL mesh, each sharded path bit-equal to its
    # unsharded counterpart
    t0 = time.perf_counter()
    routes0 = {k: dict(v) for k, v in pm.routes.items()}
    mesh = pm.make_mesh(devices=dev)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "14a: a world of one rank on NCCL")
    got, counts = counted(lambda: par.run_chains_sharded(
        sup, 14, th8, P14_STEPS, mesh, _roots, device=dev))
    require(counts == {"linreg_rss": P14_STEPS, **tree_launches(P14_STEPS)},
            f"14a: one linreg_rss launch (and one of each tree kernel) a "
            f"superstep for the {P14_CHAINS} chains: {counts}")
    want = par.run_chains_vmapped(sup, par.chain_generators(14, 1, dev)[0],
                                  th8, P14_STEPS, _roots)
    require(same(got, want), "14a: run_chains_sharded == "
            "run_chains_vmapped from the same seed, bit for bit")
    sh = par.ShardedLinReg(target.x, target.y, target.n,
                           temper=target.temper, mesh=mesh)
    got, counts = counted(lambda: sh.log_prob_batch(inp["Theta"]))
    require(counts == {"linreg_rss": 1}, f"14a: ShardedLinReg, one "
            f"launch: {counts}")
    require(torch.equal(got, target.log_prob_batch(inp["Theta"])),
            f"14a: ShardedLinReg == BayesLinReg(method='sweep') at P = "
            f"{cfg.P}, bit for bit")
    tsup = par.make_tree_sharded_superstep(target, cfg, mesh=mesh)
    got, counts = counted(lambda: tsup(None, th0, eps=inp["eps"],
                                       u=inp["u"]))
    require(counts == {"linreg_rss": 1}, f"14a: the tree superstep, one "
            f"launch: {counts}")
    plain = sup(None, th0, eps=inp["eps"], u=inp["u"])
    require(same(got, plain), "14a: the tree superstep (T = 1) == the "
            "plain superstep on injected noise, bit for bit")
    # the supersteps with collectives are declared eager: run_chain runs
    # them as the loop, bit-equal to the plain superstep's captured chain
    from pmpx_torch.samplers.base import eager_reason, run_chain
    for label, s, tree in (
            ("ShardedLinReg", pmp.make_superstep(sh, cfg),
             tree_launches(P14_EAGER)),
            ("tree superstep", tsup, {})):
        why = EAGER[label] = eager_reason(s, th0)
        require(why is not None, f"14a: the {label} is declared eager")
        gens = par.chain_generators(141, 2, dev)
        gens[1].set_state(gens[0].get_state())
        got, counts = counted(lambda: run_chain(s, gens[0], th0, P14_EAGER,
                                                collect=_roots))
        require(counts == {"linreg_rss": P14_EAGER, **tree}, f"14a: the "
                f"{label}'s chain, one launch a superstep: {counts}")
        require(same(got, run_chain(sup, gens[1], th0, P14_EAGER,
                                    collect=_roots)),
                f"14a: the {label}'s eager chain == the plain superstep's "
                "captured chain, bit for bit")
        print(f"14a: the {label} ran eager ({why}), bit-equal")
    farm_cfg = inp["farm_cfg"]
    farm = par.make_chain_farm_fused(target, farm_cfg, FARM_STEPS, mesh,
                                     chunk=FARM_STEPS)
    got, counts = counted(lambda: farm(
        par.chain_generators(14, P14_CHAINS, dev), th8))
    require(counts == {fc.FARM_KERNEL: 1}, f"14a: the meshed farm in one "
            f"launch: {counts}")
    unmeshed = par.make_chain_farm_fused(target, farm_cfg, FARM_STEPS,
                                         chunk=FARM_STEPS)(
        par.chain_generators(14, P14_CHAINS, dev), th8)
    require(torch.equal(got, unmeshed), f"14a: the meshed farm == the farm "
            f"(C = {P14_CHAINS}, binary P = {farm_cfg.P}), bit for bit")
    print(json.dumps({"phase14a": {
        "world": dist.get_world_size(), "backend": dist.get_backend(),
        "bit_equal": ["run_chains_sharded", "ShardedLinReg",
                      "tree superstep", "meshed farm"],
        "launches": dict(p14), "routes": {
            k: {r: n - routes0[k][r] for r, n in v.items()}
            for k, v in pm.routes.items()},
        "wall_s": time.perf_counter() - t0}}))
    dist.destroy_process_group()

    # 14b: P14_WORLD gloo ranks sharing the card
    t0 = time.perf_counter()
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(P14_WORLD):
            with open(f"{tmp}/rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke as c; "
                     "c.phase14_rank(*sys.argv[1:])", str(r),
                     str(P14_WORLD), f"{tmp}/init", tmp],
                    cwd=here, stdout=log, stderr=subprocess.STDOUT,
                    env=dict(os.environ, OMP_NUM_THREADS="2")))
        deadline = time.monotonic() + P14_JOIN_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r in range(P14_WORLD):
            print(f"-- rank {r} (exit {procs[r].returncode}):")
            print(Path(f"{tmp}/rank{r}.log").read_text().rstrip())
        require(all(p.returncode == 0 for p in procs),
                f"14b: every rank ended with exit 0 within {P14_JOIN_S} s")
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(P14_WORLD)]
    wall = time.perf_counter() - t0

    want = target.log_prob_batch(inp["Theta"]).cpu()
    logpi_scale = target.log_prob_batch(pmp.tree_positions(
        th0, inp["eps"], cfg.topology())).abs().max().item()
    plain = tuple(a.cpu() if torch.is_tensor(a) else
                  {k: v.cpu() for k, v in a.items()} for a in plain)
    gens = par.chain_generators(14, P14_WORLD, dev)
    b = P14_CHAINS // P14_WORLD
    blocks = [par.run_chains_vmapped(sup, gens[r], th8[r * b:(r + 1) * b],
                                     P14_STEPS, _roots)[1]
              for r in range(P14_WORLD)]
    errs = {"data_rel": 0.0, "tree_log_accept": 0.0, "tree_theta": 0.0}
    rss_each = 1 + 1 + P14_STEPS + P14_DATA_STEPS
    for r, res in enumerate(ranks):
        line = res["line"]
        require(line["launches"] == {
                    "linreg_rss": rss_each, fc.FARM_KERNEL: 1,
                    **tree_launches(P14_STEPS + P14_DATA_STEPS)},
                f"14b rank {r}: linreg_rss once a density call "
                f"({rss_each}), the tree kernels once a binary superstep "
                f"and one farm launch: {line['launches']}")
        for k, v in line["launches"].items():
            p14[k] = p14.get(k, 0) + v
        rel = ((res["data_logp"] - want).abs() / want.abs()).max().item()
        errs["data_rel"] = max(errs["data_rel"], rel)
        require(rel <= P14_RTOL, f"14b rank {r}: data = {P14_WORLD} "
                f"within rtol {P14_RTOL} of the sweep ({rel:.3g})")
        # the log weights are differences of the log-densities, so their
        # f32 error is a share of the densities' scale, max|logpi|; the
        # next state is the same node's position
        for k, a, w, scale in (
                ("tree_log_accept", res["tree"]["log_accept"],
                 plain[1]["log_accept"], logpi_scale),
                ("tree_theta", res["tree"]["theta"], plain[0], 1.0)):
            err = (a - w).abs().max().item() / scale
            errs[k] = max(errs[k], err)
            require(err <= P14_RTOL, f"14b rank {r}: tree = {P14_WORLD} "
                    f"{k} within {P14_RTOL} of the plain superstep's "
                    f"(relative to {scale:.6g}: {err:.3g})")
        for c in range(P14_WORLD):
            got = tuple(a[c * b:(c + 1) * b] for a in res["chains"])
            require(same(got, tuple(a.cpu() for a in blocks[c])),
                    f"14b rank {r}: chains block {c} == that block run "
                    f"alone from the same seed, bit for bit")
        require(torch.equal(res["farm"], unmeshed.cpu()),
                f"14b rank {r}: the farm over {P14_WORLD} chains-ranks == "
                f"the farm in one process, bit for bit")
        require(torch.equal(res["data_chains"], ranks[0]["data_chains"]),
                f"14b rank {r}: the (chains 2 x data 2) records agree")
    for c in range(2):
        posterior_check(f"14b (chains 2 x data 2) chain {c}",
                        ranks[0]["data_chains"][c], P14_DATA_BURN, target,
                        bench)
    print(json.dumps({"phase14b": {
        "world": P14_WORLD, "backend": "gloo", "device": name,
        "power": smi, "errors": errs, "wall_s": wall,
        "note": (f"{P14_WORLD} processes sharing one card: these walls "
                 "are that cost, not a scaling figure"),
        "ranks": [res["line"] for res in ranks]}}))
    return p14


def phase15_inputs(dev) -> dict:
    """Phase 15's data and proposals, made alike in every process from
    fixed seeds on the card: load_cifar10's 50,000 training images and
    load_mnist's 60,000, LeNet's theta0 and P15_NHWC_P proposals near it,
    BayesMLP's P15_BNN_P proposals near its theta0, and the SP-HMC
    sampler that cifar_hmc builds."""
    from pmpx_torch.data import load_cifar10, load_mnist
    from pmpx_torch.experiments import cifar_hmc
    from pmpx_torch.models import BayesMLP, LeNet
    from pmpx_torch.targets.nn import NNPosterior

    x, y, _, _ = load_cifar10(device=dev)
    xm, ym, _, _ = load_mnist(device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    t0 = NNPosterior(LeNet(), x[:8], y[:8], device=dev).init_theta()
    b0 = NNPosterior(BayesMLP(hidden=P15_BNN_HIDDEN), xm[:8], ym[:8],
                     stochastic=True, device=dev).init_theta()
    return {
        "x": x, "y": y, "xm": xm, "ym": ym, "theta0": t0,
        "Theta": t0 + 0.02 * torch.randn((P15_NHWC_P, t0.numel()),
                                         generator=g, device=dev),
        "Theta_bnn": b0 + 0.01 * torch.randn((P15_BNN_P, b0.numel()),
                                             generator=g, device=dev),
        "spec": cifar_hmc.sampler_spec("sp_hmc", 7, 0.1, 0.0005),
    }


def _p15_models():
    from pmpx_torch.models import LeNet, PackedLeNet

    return {"nhwc": (LeNet, P15_NHWC_P), "packed": (PackedLeNet,
                                                    P15_PACKED_P)}


def _p15_gen(dev, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def phase15_rank(rank, world, init_file, out_dir) -> None:
    """One rank of phase 15b, in a process of its own: a gloo world of
    ``world`` ranks (``file://`` init) that share the card, each with its
    shard of the images.  Runs the sharded LeNet (nhwc, packed), BayesMLP
    and one SP-HMC superstep, every rank alike; saves what it got to
    ``out_dir/rank{rank}.pt`` and prints its device, collectives by
    route, peak GiB and ms per ``value_and_grad_batch`` as one JSON line."""
    import datetime

    import torch.distributed as dist

    from pmpx_torch import parallel as par
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.models import BayesMLP
    from pmpx_torch.parallel import mesh as pm
    from pmpx_torch.targets.nn import NNPosterior

    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=P15_JOIN_S))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    inp = phase15_inputs(dev)
    mesh = pm.make_mesh(data=world)
    d = mesh.get_local_rank(pm.AXIS_DATA)
    reset_launches()
    res, line = {}, {"rank": rank, "current_device":
                     f"cuda:{torch.cuda.current_device()}",
                     "device": torch.cuda.get_device_name(dev)}

    def shard(x, y):
        m = x.shape[0] // world
        return x[d * m:(d + 1) * m], y[d * m:(d + 1) * m]

    def timed(label, fn):
        """fn() once for the result, once more timed; its peak GiB."""
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        line[f"{label}_vg_ms"] = (time.perf_counter() - t0) * 1e3
        line[f"{label}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return tuple(a.cpu() for a in out)

    n = inp["x"].shape[0]
    x_l, y_l = shard(inp["x"], inp["y"])
    posts = {}
    for label, (cls, P) in _p15_models().items():
        s = par.ShardedNNPosterior.from_posterior(
            NNPosterior(cls(), x_l, y_l, device=dev), x_l, y_l, n,
            mesh=mesh)
        posts[label] = s
        res[label] = timed(label, lambda s=s, P=P: s.value_and_grad_batch(
            inp["Theta"][:P]))
    xm_l, ym_l = shard(inp["xm"], inp["ym"])
    bnn = par.ShardedNNPosterior.from_posterior(
        NNPosterior(BayesMLP(hidden=P15_BNN_HIDDEN), xm_l, ym_l,
                    stochastic=True, device=dev),
        xm_l, ym_l, inp["xm"].shape[0], mesh=mesh)
    res["bnn"] = timed("bnn", lambda: bnn.value_and_grad_batch(
        inp["Theta_bnn"], generator=_p15_gen(dev, 151)))
    sup = inp["spec"].build(posts["nhwc"])
    th, out = sup(_p15_gen(dev, 152), inp["theta0"])
    torch.cuda.synchronize()
    res["hmc"] = (th.cpu(), bool(out["accepted"]),
                  float(out["log_accept"]))
    line["launches"] = {k: v for k, v in launches.items() if v}
    line["routes"] = pm.routes
    line["shard_images"] = int(x_l.shape[0])
    res["line"] = line
    torch.save(res, f"{out_dir}/rank{rank}.pt")
    print(json.dumps(line), flush=True)
    dist.destroy_process_group()


def phase15(dev, name: str, smi: str) -> dict:
    """Phase 15's runs and gates: 15a in this process on a one-rank NCCL
    mesh, then the unsharded BayesMLP reference, then 15b in P15_WORLD
    gloo ranks sharing the card; returns the hand kernels' launches (none
    expected)."""
    import torch.distributed as dist

    from pmpx_torch import parallel as par
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.models import BayesMLP, LeNet
    from pmpx_torch.parallel import mesh as pm
    from pmpx_torch.samplers.base import eager_reason
    from pmpx_torch.targets.nn import NNPosterior

    def vg_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    inp = phase15_inputs(dev)
    x, y, n = inp["x"], inp["y"], inp["x"].shape[0]
    reset_launches()

    # 15a: a one-rank NCCL mesh, each sharded posterior against the
    # unsharded one, deterministic algorithms on (cuDNN's backward may
    # otherwise sum in another order from one call to the next)
    t0 = time.perf_counter()
    routes0 = dict(pm.routes["all_reduce"])
    mesh = pm.make_mesh(devices=dev)
    require(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
            "15a: a world of one rank on NCCL")
    refs, rec = {}, {}
    cases = [("nhwc", lambda: LeNet(), P15_NHWC_P),
             ("nhwc_remat", lambda: LeNet(remat=True), P15_NHWC_P),
             ("packed", _p15_models()["packed"][0], P15_PACKED_P)]
    with deterministic() as flagged:
        for label, make, P in cases:
            Th = inp["Theta"][:P]
            post = NNPosterior(make(), x, y, device=dev)
            s = par.ShardedNNPosterior.from_posterior(post, x, y, n,
                                                      mesh=mesh)
            a, b = s.log_prob_batch(Th), post.log_prob_batch(Th)
            require(torch.equal(a, b), f"15a {label}: log_prob_batch == "
                    f"NNPosterior's at P = {P}, bit for bit ({a.tolist()} "
                    f"against {b.tolist()})")
            tv, tg = post.value_and_grad_batch(Th)
            torch.cuda.reset_peak_memory_stats()
            sv, sg = s.value_and_grad_batch(Th)
            peak = torch.cuda.max_memory_allocated() / 2**30
            # each timed warm, once more
            t_ms = vg_ms(lambda: post.value_and_grad_batch(Th))[1]
            s_ms = vg_ms(lambda: s.value_and_grad_batch(Th))[1]
            gap = float((sg - tg).abs().max() / tg.abs().max())
            require(torch.equal(sv, tv), f"15a {label}: the values of "
                    f"value_and_grad_batch bit for bit ({sv.tolist()} "
                    f"against {tv.tolist()})")
            require(gap <= P15_GAP, f"15a {label}: gradients within "
                    f"{P15_GAP} max|g| ({gap:.3g})")
            rec[label] = {"P": P, "grad_gap_over_max": gap,
                          "grad_bit_equal": bool(torch.equal(sg, tg)),
                          "sharded_vg_ms": s_ms, "unsharded_vg_ms": t_ms,
                          "sharded_peak_gib": peak}
            if label != "nhwc_remat":
                refs[label] = (tv.cpu(), tg.cpu())
            if label == "nhwc":
                spec = inp["spec"]
                # its density all-reduces: run_chain keeps it eager
                why = EAGER["ShardedNNPosterior sp_hmc"] = eager_reason(
                    spec.build(s), inp["theta0"])
                require(why is not None, "15a: SP-HMC over the sharded "
                        "LeNet is declared eager")
                a = spec.build(s)(_p15_gen(dev, 152), inp["theta0"])
                b = spec.build(post)(_p15_gen(dev, 152), inp["theta0"])
                hmc_gap = float((a[0] - b[0]).abs().max())
                rec["sp_hmc"] = {k: [float(a[1][k]), float(b[1][k])]
                                 for k in ("accepted", "log_accept")}
                require(hmc_gap <= (0.0 if rec[label]["grad_bit_equal"]
                                    else P15_HMC_TOL),
                        f"15a: one SP-HMC superstep over the sharded LeNet "
                        f"== the unsharded one from the same generator "
                        f"({hmc_gap:.3g})")
                rec["sp_hmc_theta_gap"] = hmc_gap
                refs["hmc"] = b[0].cpu()
            del post, s, tv, tg, sv, sg
            torch.cuda.empty_cache()
    routes_a = {r: v - routes0[r] for r, v in pm.routes["all_reduce"].items()}
    require(routes_a["host"] == 0, "15a: every collective on NCCL direct")
    print(json.dumps({"phase15a": {
        "world": dist.get_world_size(), "backend": dist.get_backend(),
        "n_images": n, "cases": rec, "all_reduce_routes": routes_a,
        "nondeterministic_ops": sorted(flagged),
        "wall_s": time.perf_counter() - t0, "device": name, "power": smi}}))
    dist.destroy_process_group()

    # the unsharded BayesMLP on the MNIST stand-ins, from the ranks' seed
    bnn = NNPosterior(BayesMLP(hidden=P15_BNN_HIDDEN), inp["xm"], inp["ym"],
                      stochastic=True, device=dev)
    refs["bnn"] = tuple(a.cpu() for a in bnn.value_and_grad_batch(
        inp["Theta_bnn"], generator=_p15_gen(dev, 151)))
    del bnn, inp, x, y
    torch.cuda.empty_cache()
    p15 = {k: v for k, v in launches.items() if v}
    require(not p15, f"15a: no hand kernel on this path: {p15}")

    # 15b: P15_WORLD gloo ranks sharing the card
    t0 = time.perf_counter()
    here = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for r in range(P15_WORLD):
            with open(f"{tmp}/rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", "import sys, chip_smoke as c; "
                     "c.phase15_rank(*sys.argv[1:])", str(r),
                     str(P15_WORLD), f"{tmp}/init", tmp],
                    cwd=here, stdout=log, stderr=subprocess.STDOUT,
                    env=dict(os.environ, OMP_NUM_THREADS="2")))
        deadline = time.monotonic() + P15_JOIN_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for r in range(P15_WORLD):
            print(f"-- rank {r} (exit {procs[r].returncode}):")
            print(Path(f"{tmp}/rank{r}.log").read_text().rstrip())
        require(all(p.returncode == 0 for p in procs),
                f"15b: every rank ended with exit 0 within {P15_JOIN_S} s")
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(P15_WORLD)]
    wall = time.perf_counter() - t0

    errs = {}
    for r, res in enumerate(ranks):
        line = res["line"]
        require(line["current_device"] == "cuda:0" and not line["launches"],
                f"15b rank {r}: on cuda:0, no hand kernel: {line}")
        require(line["routes"]["all_reduce"]["direct"] == 0,
                f"15b rank {r}: every collective through the host (gloo)")
        for label in ("nhwc", "packed", "bnn"):
            (v, g), (wv, wg) = res[label], refs[label]
            v_err = float(((v - wv).abs() / (P15_VAL_ATOL + P15_VAL_RTOL
                                             * wv.abs())).max())
            g_err = float(((g - wg).abs() / (P15_GRAD_ATOL + P15_GRAD_RTOL
                                             * wg.abs())).max())
            e = errs.setdefault(label, {"value_rel": 0.0, "grad_over_max":
                                        0.0, "value_tol_share": 0.0,
                                        "grad_tol_share": 0.0})
            e["value_rel"] = max(e["value_rel"], float(
                ((v - wv).abs() / wv.abs()).max()))
            e["grad_over_max"] = max(e["grad_over_max"], float(
                (g - wg).abs().max() / wg.abs().max()))
            e["value_tol_share"] = max(e["value_tol_share"], v_err)
            e["grad_tol_share"] = max(e["grad_tol_share"], g_err)
            require(v_err <= 1.0 and g_err <= 1.0,
                    f"15b rank {r} {label}: values and gradients within "
                    f"pmpx's tolerances (shares of them: {v_err:.3g}, "
                    f"{g_err:.3g})")
        th, acc, log_acc = res["hmc"]
        res["line"]["sp_hmc"] = {"accepted": acc, "log_accept": log_acc}
        hmc = float((th - refs["hmc"]).abs().max())
        errs["sp_hmc_theta"] = max(errs.get("sp_hmc_theta", 0.0), hmc)
        require(torch.equal(th, ranks[0]["hmc"][0]) and hmc <= P15_HMC_TOL,
                f"15b rank {r}: the SP-HMC superstep ends at rank 0's "
                f"theta, within {P15_HMC_TOL} of the unsharded one "
                f"({hmc:.3g})")
    print(json.dumps({"phase15b": {
        "world": P15_WORLD, "backend": "gloo", "device": name,
        "power": smi, "errors": errs, "wall_s": wall,
        "note": (f"{P15_WORLD} processes sharing one card: these times "
                 "are that cost, not a scaling figure"),
        "ranks": [res["line"] for res in ranks]}}))
    print(json.dumps({"phase15_reduced": [
        "cifar_hmc SP-HMC num_steps 1, in 15a and 15b (the paper's "
        "50,000)"]}))
    return p15


def phase16(dev, name: str, smi: str, bench) -> dict:
    """The compiled chain: run_chain (a replayed CUDA graph) against its
    plain version, the eager loop, on the benchmark cell.  Returns the
    phase's launches of the captured runs, by kernel."""
    from benchmark.metrics._spans import host_us, outside_pct
    from pmpx_torch import checkpoint as ck
    from pmpx_torch import profiling
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.samplers import base, pmp

    target = bench.bench_target(dev)
    th0 = bench.theta0(dev)
    cfgs = {
        "pmp_binary_P1024": bench.bench_config(),
        "mp_N7": pmp.PMPConfig(N=7, depth=1, step_size=0.02,
                               selection="all_first"),
        "general_7x3": pmp.PMPConfig(N=7, depth=3, step_size=0.02,
                                     selection="all_first"),
    }
    phase_counts: dict = {}

    def collect(th, o):
        return th, o["root_index"], o["root_logp"]

    def same(a, b) -> bool:
        la, lb = base._leaves(a), base._leaves(b)
        return len(la) == len(lb) and all(
            x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(la, lb))

    def pair(seed):
        gs = []
        for _ in range(2):
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            gs.append(g)
        return gs

    with torch.no_grad():
        # 16a: captured == eager, bit for bit
        for label, cfg in cfgs.items():
            for unroll in (1, P16_UNROLL):
                sup = pmp.make_superstep(target, cfg)
                ga, gb = pair(16)
                reset_launches()
                want = base.run_chain_eager(sup, ga, th0, P16_STEPS,
                                            collect=collect)
                eager_counts = dict(launches)
                reset_launches()
                got = base.run_chain(sup, gb, th0, P16_STEPS,
                                     collect=collect, unroll=unroll)
                torch.cuda.synchronize()
                counts = dict(launches)
                for k, v in counts.items():
                    phase_counts[k] = phase_counts.get(k, 0) + v
                print(f"16a {label} unroll {unroll}: launches captured "
                      f"{ {k: v for k, v in counts.items() if v} }, eager "
                      f"{ {k: v for k, v in eager_counts.items() if v} }")
                require(same(want, got), f"16a {label} unroll {unroll}: "
                        "records and final state bit-equal")
                require(torch.equal(ga.get_state(), gb.get_state()),
                        f"16a {label} unroll {unroll}: generator state")
                require(counts == eager_counts
                        and counts["linreg_rss"] == P16_STEPS,
                        f"16a {label}: one linreg_rss launch a superstep, "
                        "counted per replay")
        # 16b: a resume in P16_CHUNKS chunks == one captured run == eager
        sup = pmp.make_superstep(target, cfgs["general_7x3"])
        ga, gb = pair(17)
        want = base.run_chain_eager(sup, ga, th0, P16_STEPS,
                                    collect=lambda th, o: th)
        captures, marks = [], []
        capture = base.CompiledChain._capture

        def spy(chain, steps):
            captures.append(steps)
            return capture(chain, steps)

        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/c.ckpt"
            ck.save_checkpoint(path, th0, gb, 0)
            reset_launches()
            base.CompiledChain._capture = spy
            try:
                thR, chunks = ck.resume_chain(
                    sup, path, P16_STEPS, collect=lambda th, o: th,
                    checkpoint_every=P16_STEPS // P16_CHUNKS,
                    on_chunk=lambda step, recs: marks.append(len(captures)))
            finally:
                base.CompiledChain._capture = capture
            counts = dict(launches)
            _, gR, stepR, _ = ck.load_checkpoint(path)
        for k, v in counts.items():
            phase_counts[k] = phase_counts.get(k, 0) + v
        require(len(chunks) == P16_CHUNKS and torch.equal(thR, want[0])
                and np.array_equal(np.concatenate(chunks),
                                   want[1].cpu().numpy()),
                "16b resumed chunks bit-equal to the eager chain")
        require(stepR == P16_STEPS
                and torch.equal(gR.get_state(), ga.get_state()),
                "16b the checkpoint's generator state")
        require(captures[:1] == [1] and len(captures) <= 2
                and set(marks) == {len(captures)},
                f"16b the one-step graph and the chosen one, captured in the "
                f"first chunk only (graphs of {captures} supersteps, "
                f"{marks} captured after each chunk)")
        print(f"16b resume in {P16_CHUNKS} chunks of "
              f"{P16_STEPS // P16_CHUNKS}: bit-equal; launches {counts}")

        # 16c: the sweep's us per superstep, eager and captured
        sup = pmp.make_superstep(target, cfgs["pmp_binary_P1024"])
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        chain = base.compile_chain(sup, g, th0, bench._theta,
                                   P16_SWEEP_UNROLL)
        runs = {"eager": lambda n: base.run_chain_eager(
                    sup, g, th0, n, collect=bench._theta),
                "captured": lambda n: chain.run(g, th0, n)}
        for fn in runs.values():  # warm-up: the capture, outside the clock
            fn(20)
        graphs = dict(chain.chunks)
        times = {k: [] for k in runs}
        for rep in range(P16_REPS):
            order = ("eager", "captured") if rep % 2 == 0 else (
                "captured", "eager")
            for k in order:
                ms = event_ms(lambda f=runs[k]: f(SWEEP_PATH_STEPS), 1,
                              warmup=False)
                times[k].append(ms * 1e3 / SWEEP_PATH_STEPS)
        profiles = {}
        for k, f in runs.items():
            prof = bench.profile_path(lambda f=f: f(P16_TRACE))
            prof["kernels_per_superstep"] = prof["kernels"] / P16_TRACE
            prof["busy_us_per_superstep"] = (prof["device_busy_us"]
                                             / P16_TRACE)
            prof["supersteps"] = P16_TRACE
            profiling.reset()
            with profiling.recording():
                f(P16_TRACE)
            found = profiling.spans()
            profiling.reset()
            prof["outside_chain_pct"] = outside_pct(found)
            prof["launch_host_us"] = host_us(found)
            prof["chain_us_per_superstep"] = sum(
                s["device_end_us"] - s["device_start_us"] for s in found
                if s["name"] == "chain.replay") / P16_TRACE
            profiles[k] = prof
            print(json.dumps({"profile": f"sweep_{k}", **prof}))
        require(chain.chunks == graphs, "16c the timed, traced and recorded "
                "runs only replayed (no capture after the warm-up)")
    for k, p in profiles.items():
        require(0.0 <= p["outside_chain_pct"] <= 100.0,
                f"16c the {k} sweep's outside_chain_pct in [0, 100]: "
                f"{p['outside_chain_pct']!r}")
    # in the eager loop a superstep's span also holds the card's idle
    # between the host's launches, so its share is no idle yardstick: the
    # device time a superstep compares the two
    require(profiles["captured"]["outside_chain_pct"] < 10.0,
            "16c the captured sweep's card time is >= 90% its replays")
    require(profiles["captured"]["chain_us_per_superstep"]
            < profiles["eager"]["chain_us_per_superstep"],
            "16c the captured sweep's supersteps take the card less time")

    # 16d: a device-bound NN cell, the MNIST-LSTM MH chain through
    # lstm_fused at full batch, captured against eager
    from pmpx_torch.data import load_mnist
    from pmpx_torch.experiments import mnist as mnist_mod
    from pmpx_torch.kernels import lstm_fused as lf
    from pmpx_torch.models import MnistLSTM
    from pmpx_torch.targets.nn import NNPosterior

    x_tr, y_tr, _, _ = load_mnist(60_000, 10_000, device=dev)
    post = NNPosterior(MnistLSTM(), x_tr, y_tr, temper=10.0, device=dev)
    lf.attach(post)
    sup = mnist_mod.sampler_spec("mh", 1e-4, 7).build(post)
    th_l = post.init_theta()
    lstm = {}

    def collect_mh(th, o):
        return th, o["accepted"], o["root_logp"]

    def peak_gib(fn):
        """fn()'s result, and the peak device memory (allocated, and
        reserved by the caching allocator, graph pools included) it took
        above what was allocated when it started, in GiB."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, {
            "allocated": (torch.cuda.max_memory_allocated() - start) / 2**30,
            "reserved": (torch.cuda.max_memory_reserved() - start) / 2**30}

    with torch.no_grad():
        ga, gb = pair(18)
        want, peak_eager = peak_gib(lambda: base.run_chain_eager(
            sup, ga, th_l, P16_LSTM_STEPS, collect=collect_mh))
        reset_launches()
        got, peak_captured = peak_gib(lambda: base.run_chain(
            sup, gb, th_l, P16_LSTM_STEPS, collect=collect_mh))
        lstm["peak_gib"] = {"eager": peak_eager, "captured": peak_captured}
        counts = {k: v for k, v in launches.items() if v}
        for k, v in counts.items():
            phase_counts[k] = phase_counts.get(k, 0) + v
        require(same(want, got)
                and torch.equal(ga.get_state(), gb.get_state()),
                "16d the MNIST-LSTM MH chain, captured == eager")
        require(counts == {"lstm_fused": P16_LSTM_STEPS},
                f"16d one lstm_fused launch a superstep: {counts}")
        chain = base.compile_chain(sup, g, th_l, collect_mh)
        runs = {"eager": lambda n: base.run_chain_eager(
                    sup, g, th_l, n, collect=collect_mh),
                "captured": lambda n: chain.run(g, th_l, n)}
        for k, f in runs.items():
            f(1)  # warm-up: the capture, outside the clock
            lstm[k] = event_ms(lambda f=f: f(P16_LSTM_STEPS), 1,
                               warmup=False) * 1e3 / P16_LSTM_STEPS
            prof = bench.profile_path(lambda f=f: f(P16_LSTM_TRACE))
            lstm[f"{k}_kernels_per_superstep"] = (prof["kernels"]
                                                  / P16_LSTM_TRACE)
            lstm[f"{k}_busy_us_per_superstep"] = (prof["device_busy_us"]
                                                  / P16_LSTM_TRACE)
            lstm[f"{k}_top"] = prof["top"][:3]
    del post, sup, chain, runs
    from pmpx_torch.models import MnistMLP

    post = NNPosterior(MnistMLP(), x_tr, y_tr, temper=10.0, device=dev)
    sup = mnist_mod.sampler_spec("pmp", 1e-4, 7).build(post)
    th_f = post.init_theta()
    with torch.no_grad():
        ga, gb = pair(19)
        _, fc_eager = peak_gib(lambda: base.run_chain_eager(
            sup, ga, th_f, P16_FC_STEPS, collect=bench._theta))
        (fin, tr), fc_captured = peak_gib(lambda: base.run_chain(
            sup, gb, th_f, P16_FC_STEPS, collect=bench._theta))
    require(tr.shape == (P16_FC_STEPS, *th_f.shape)
            and bool(torch.isfinite(tr).all()),
            "16d the captured MNIST-FC PMP chain: finite states")
    lstm["fc_pmp_peak_gib"] = {"eager": fc_eager, "captured": fc_captured,
                               "supersteps": P16_FC_STEPS}
    del post, sup, x_tr, y_tr, fin, tr
    print(json.dumps({"compiled_chain": "mnist_lstm_mh_kernel",
                      "supersteps": P16_LSTM_STEPS, "us_per_superstep": lstm,
                      "device": name, "power": smi}))
    print(json.dumps({
        "compiled_chain": "pmp_p1024_n100k",
        "sweep_us_per_superstep": times,
        "kernels_per_superstep": {
            k: p["kernels_per_superstep"] for k, p in profiles.items()},
        "busy_us_per_superstep": {
            k: p["busy_us_per_superstep"] for k, p in profiles.items()},
        # untraced, under profiling.recording(): the card's share outside
        # the superstep's own work, the host µs a call
        "outside_chain_pct": {
            k: p["outside_chain_pct"] for k, p in profiles.items()},
        "launch_host_us": {
            k: p["launch_host_us"] for k, p in profiles.items()},
        "eager": EAGER,
        "device": name, "power": smi}))
    return phase_counts



def phase17_child(launches_file: str, *args) -> None:
    """A 17c stage's child process: ``pmpx_torch.cli run <args>`` with
    deterministic algorithms on; appends its kernel launches to
    ``launches_file`` as one JSON line and exits with the CLI's code."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    from pmpx_torch import cli
    from pmpx_torch.kernels import launches

    rc = cli.main(["run", *args])
    with open(launches_file, "a") as f:
        f.write(json.dumps(launches) + "\n")
    sys.exit(rc)


def phase17_stage(launches_file: str, kill_marker: str, watch: str,
                  delay: str, *args) -> None:
    """A 17c queue stage (a ``cmd`` stage of the queue): runs
    :func:`phase17_child` on ``args``.  Given a ``kill_marker`` that does
    not exist yet, it SIGKILLs the child once, ``delay`` seconds after
    ``watch`` (the first chunk's trace) appears, writes the marker and
    exits 137, so that the queue retries the stage.  The stage runs this
    function's source alone (:func:`_stage_code`), without torch."""
    proc = subprocess.Popen([sys.executable, "-c",
                             "import sys, chip_smoke as c; "
                             "c.phase17_child(*sys.argv[1:])",
                             launches_file, *args])
    if kill_marker != "-" and not os.path.exists(kill_marker):
        while proc.poll() is None and not os.path.exists(watch):
            time.sleep(0.01)
        time.sleep(float(delay))
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            Path(kill_marker).write_text("killed")
            sys.exit(137)
    sys.exit(proc.wait())


def _stage_code() -> str:
    """:func:`phase17_stage`'s source and its call: a script that needs
    neither torch nor this module."""
    import inspect

    return ("import os, signal, subprocess, sys, time\n"
            "from pathlib import Path\n"
            + inspect.getsource(phase17_stage)
            + "phase17_stage(*sys.argv[1:])\n")


def phase17(dev, name: str, smi: str) -> dict:
    """The repo's entry points outside the package, through the paths a
    user runs (17a-17d).  The cut queue (17c) runs in a thread beside 17a
    and 17b: its stages are subprocesses, most of whose time is their
    start and the device probe before each.  Returns the phase's launches
    by kernel: this process's and those the queue's wrapped stages
    reported."""
    import importlib.util
    import threading

    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.metrics.recorder import reference_style_name

    here = Path(__file__).resolve().parent
    counts: dict = {}
    torch.cuda.empty_cache()  # the queue's stages share the card

    def add(got: dict) -> None:
        for k, v in got.items():
            if v:
                counts[k] = counts.get(k, 0) + v

    def script(rel: str):
        spec = importlib.util.spec_from_file_location(
            f"_phase17_{Path(rel).stem}", here / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    with tempfile.TemporaryDirectory() as tmp:
        qd = Path(tmp)
        # 17c, started first: the cut queue
        rp = script("scripts/run_paper_torch.py")
        rp.STATE_DIR = str(qd / "queue")
        rp.COOLDOWN_S = 1
        stem = reference_style_name("MH", 1e-4, Q_LSTM_STEPS, model="LSTM",
                                    N=7)
        hard = ["--class-sep", "0.35", "--label-noise", "0.05"]
        lstm = ["mnist", "--model", "LSTM", "--algo", "mh", "--scale",
                "paper", "--num-steps", str(Q_LSTM_STEPS), "--chunk-steps",
                str(Q_LSTM_CHUNK), "--pretrain-steps", str(Q_LSTM_PRETRAIN),
                "--lstm-kernel", "true", "--resume", "true", *hard]
        wrapper = qd / "stage.py"
        wrapper.write_text(_stage_code())

        def wrapped(stage, args, kill="-", watch="-"):
            return [str(wrapper), str(qd / f"{stage}.launches"), kill, watch,
                    str(Q_KILL_DELAY_S), *args]

        def hmc(exp, algo, steps, chunk, out):
            return [exp, "--algo", algo, "--scale", "paper", "--num-steps",
                    str(steps), "--chunk-steps", str(chunk), "--resume",
                    "true", "--out-dir", str(qd / out)]

        cifar = ["--compute-dtype", "bf16", "--pretrain-steps",
                 str(Q_CIFAR_PRETRAIN), *hard]
        stages = [
            {"name": "lstm_mh_killed", "cmd": wrapped(
                "lstm_mh_killed",
                lstm + ["--out-dir", str(qd / "mnist_kernel")],
                kill=str(qd / "killed"),
                watch=str(qd / "mnist_kernel" / f"{stem}.loss.npy"))},
            {"name": "lstm_mh_straight", "cmd": wrapped(
                "lstm_mh_straight", lstm + ["--out-dir", str(qd / "straight")])},
            {"name": "cifar_sp", "argv": hmc(
                "cifar_hmc", "sp_hmc", Q_CIFAR_STEPS, Q_CIFAR_CHUNK, "cifar")
                + cifar},
            {"name": "cifar_pmp", "argv": hmc(
                "cifar_hmc", "pmp_hmc", Q_CIFAR_STEPS, Q_CIFAR_CHUNK,
                "cifar") + cifar},
            {"name": "bnn_sp", "argv": hmc("bnn", "sp_hmc", Q_BNN_STEPS,
                                           Q_BNN_CHUNK, "bnn_flagship")},
            {"name": "bnn_pmp", "argv": hmc("bnn", "pmp_hmc", Q_BNN_STEPS,
                                            Q_BNN_CHUNK, "bnn_flagship")
                + ["--n", "2"]},
            {"name": "ess_fused", "cmd": wrapped("ess_fused", [
                "ess_msjd", "--trace", "all", "--method", "fused_chain",
                "--Ps", "8,512", "--algos", "mp,pmp", "--n-data", "100000",
                "--num-steps", str(Q_ESS_STEPS), "--burn-in",
                str(Q_ESS_BURN), "--out-dir", str(qd / "ess_fused")])},
            {"name": "summarize", "cmd": [
                "scripts/summarize_paper_torch.py", "all", str(qd)]},
        ]
        qpath = qd / "queue.json"
        qpath.write_text(json.dumps({"stages": stages}))
        queue: dict = {}

        def run_queue():
            t0 = time.perf_counter()
            try:
                queue["rc"] = rp.main(str(qpath))
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                queue["error"] = e
            queue["wall_s"] = time.perf_counter() - t0

        runner = threading.Thread(target=run_queue, daemon=True)
        runner.start()

        # 17a: the examples as a user runs them, side by side
        procs, walls, outs = {}, {}, {}
        t0 = time.perf_counter()
        for rel in ("examples/quickstart_torch.py",
                    "examples/bayesian_nn_torch.py"):
            procs[rel] = subprocess.Popen(
                [sys.executable, rel], cwd=here, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for rel, proc in procs.items():
            out, err = proc.communicate(timeout=P17_TIMEOUT_S)
            walls[rel] = time.perf_counter() - t0
            print(out, end="")
            require(proc.returncode == 0, f"17a {rel} exits 0 ({err[-1500:]})")
            outs[rel] = out
        num = r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?"
        q = outs["examples/quickstart_torch.py"]
        means = [float(re.search(rf"E\[x{i}\] = ({num})", q).group(1))
                 for i in (1, 2)]
        ess = [float(v) for v in re.findall(
            num, re.search(r"ESS per dim: \[([^\]]*)\]", q).group(1))]
        z = [abs(means[i] - BANANA_MEAN[i]) * math.sqrt(ess[i])
             / BANANA_SD[i] for i in range(2)]
        require("samples: (128000, 2)" in q, "17a the quickstart's samples")
        require(max(z) < P17_Z, f"17a the quickstart's means {means} within "
                f"{P17_Z} MCSE of (0, -8): z {z}")
        loss = re.search(rf"loss: ({num}) -> ({num})",
                         outs["examples/bayesian_nn_torch.py"])
        require(float(loss.group(2)) < float(loss.group(1)),
                "17a bayesian_nn's last loss below its first")
        print(json.dumps({"phase17a": {
            "wall_s": walls, "quickstart_means": means,
            "quickstart_ess": ess, "quickstart_z": z,
            "bayesian_nn_loss": [float(loss.group(1)),
                                 float(loss.group(2))],
            "beside": "the 17c queue", "device": name, "power": smi}}))

        # 17b: the NN zoo at its widths and batch sizes
        zoo = script("scripts/run_zoo_torch.py")
        cells = [(f, dict(kw, num_steps=ZOO_MNIST_STEPS) if f == "mnist"
                  else kw) for f, kw in zoo.CELLS]
        reset_launches()
        t0 = time.perf_counter()
        rows = zoo.main(cells, str(qd / "zoo"), device=dev)
        zoo_wall = time.perf_counter() - t0
        add(launches)
        for fam in ("mnist", "cifar"):
            require((qd / "zoo" / f"{fam}_zoo" / "summary.json").exists(),
                    f"17b the {fam} zoo's summary")
        flat = rows["mnist"] + rows["cifar"]
        require(len(flat) == 12 and all(
            math.isfinite(r["loss_first"]) and math.isfinite(r["loss_last"])
            for r in flat), "17b 12 cells with finite losses")
        print(json.dumps({"phase17b": {
            "wall_s": zoo_wall,
            "cells": [{k: r.get(k) for k in ("model", "algo", "wall_s",
                                             "loss_first", "loss_last",
                                             "test_acc", "test_acc_last")}
                      for r in flat],
            "launches": {k: v for k, v in launches.items() if v},
            "beside": "the 17c queue", "device": name, "power": smi}}))

        # 17c's gates, once its queue has drained
        runner.join(timeout=P17_QUEUE_S)
        require(not runner.is_alive(), f"17c the queue drains within "
                f"{P17_QUEUE_S} s")
        if "error" in queue:
            raise queue["error"]
        state = Path(rp.STATE_DIR)
        done = {s["name"]: json.loads((state / f"{s['name']}.done")
                                      .read_text())
                for s in stages if (state / f"{s['name']}.done").exists()}
        require(queue["rc"] == 0 and len(done) == len(stages)
                and not list(state.glob("*.failed")),
                f"17c every stage ends rc 0: {sorted(done)}")
        require(done["lstm_mh_killed"]["attempts"] == 2
                and (qd / "killed").exists()
                and all(d["attempts"] == 1 for k, d in done.items()
                        if k != "lstm_mh_killed"),
                "17c the killed stage retried once, the others ran once")
        # the retry resumed from the checkpoint: the trace and the final
        # accuracies equal the straight run's, bit for bit
        a, b = qd / "mnist_kernel", qd / "straight"
        ta, tb = (np.load(d / f"{stem}.loss.npy") for d in (a, b))
        ja, jb = (json.loads((d / f"{stem}.json").read_text())
                  for d in (a, b))
        require(ta.shape == (Q_LSTM_STEPS,) and np.array_equal(ta, tb)
                and (ja["train_acc"], ja["test_acc"])
                == (jb["train_acc"], jb["test_acc"]),
                "17c the killed-and-resumed trace equals the straight one")
        lines = {s: [json.loads(ln) for ln in
                     (qd / f"{s}.launches").read_text().splitlines()]
                 for s in ("lstm_mh_killed", "lstm_mh_straight",
                           "ess_fused")}
        resumed = lines["lstm_mh_killed"][0]["lstm_fused"]
        require([ln["lstm_fused"] for ln in lines["lstm_mh_straight"]]
                == [Q_LSTM_STEPS] and len(lines["lstm_mh_killed"]) == 1
                and resumed % Q_LSTM_CHUNK == 0
                and 0 < resumed < Q_LSTM_STEPS,
                f"17c one lstm_fused launch a superstep: the straight run "
                f"{lines['lstm_mh_straight']}, the resumed attempt {resumed}")
        require(all(lines["ess_fused"][0][k] > 0
                    for k in ("fused_chain_all", "fused_chain_mp_all")),
                f"17c the fused ESS stage's chain kernels: "
                f"{lines['ess_fused']}")
        for got in lines.values():
            for ln in got:
                add(ln)
        # the summaries count the stages' supersteps
        cif = json.loads((qd / "cifar" / "summary.json").read_text())
        bnn = json.loads((qd / "bnn_flagship" / "bnn_flagship.json")
                         .read_text())
        mn = json.loads((qd / "mnist" / "summary.json").read_text())
        steps = {"cifar_sp_hmc": cif["sp_hmc"]["steps"],
                 "cifar_pmp_hmc": cif["pmp_hmc"]["steps"],
                 "bnn_sp_hmc": bnn["sp_hmc"]["steps"],
                 "bnn_pmp_hmc": bnn["pmp_hmc"]["steps"],
                 "mnist_lstm_mh_kernel": mn[f"{stem}@kernel"]["steps"]}
        require(steps == {"cifar_sp_hmc": Q_CIFAR_STEPS,
                          "cifar_pmp_hmc": Q_CIFAR_STEPS,
                          "bnn_sp_hmc": Q_BNN_STEPS,
                          "bnn_pmp_hmc": Q_BNN_STEPS,
                          "mnist_lstm_mh_kernel": Q_LSTM_STEPS},
                f"17c the summaries' step counts: {steps}")
        # a second run of the queue starts nothing
        n_attempts = sum(p.read_text().count("=== attempt")
                         for p in state.glob("*.log"))
        files = sorted(str(p) for p in qd.rglob("*"))
        t1 = time.perf_counter()
        rc2 = rp.main(str(qpath))
        rerun_s = time.perf_counter() - t1
        require(rc2 == 0 and n_attempts == len(stages) + 1
                and sum(p.read_text().count("=== attempt")
                        for p in state.glob("*.log")) == n_attempts
                and sorted(str(p) for p in qd.rglob("*")) == files,
                "17c a second run of the queue starts no stage")
        ess_rows = json.loads((qd / "ess_fused" / "ess_msjd.json")
                              .read_text())["rows"]
        ess_dt = np.load(qd / "ess_fused" / "ess_msjd.npz")["rows"][:, 2]
        print(json.dumps({"phase17c": {
            "wall_s": queue["wall_s"], "rerun_s": rerun_s,
            "stages": {k: {"wall_s": d["wall_s"], "attempts": d["attempts"]}
                       for k, d in done.items()},
            "killed_resumed_launches": resumed,
            "steps": steps,
            "steady_ms_per_superstep": {
                "cifar_sp_hmc": cif["sp_hmc"]["steady_ms_per_superstep"],
                "cifar_pmp_hmc": cif["pmp_hmc"]["steady_ms_per_superstep"],
                "bnn_sp_hmc": bnn["sp_hmc"]["steady_ms_per_superstep"],
                "bnn_pmp_hmc": bnn["pmp_hmc"]["steady_ms_per_superstep"],
                "mnist_lstm_mh_kernel":
                    mn[f"{stem}@kernel"]["steady_ms_per_superstep"]},
            "ess_fused_cell_wall_s": dict(zip(ess_rows, ess_dt.tolist())),
            "launches": lines,
            "beside": "17a and 17b", "device": name, "power": smi}}))

    # 17d: the small-P profile at its defaults, the card to itself
    prof = script("scripts/profile_smallp_torch.py")
    reset_launches()
    got = prof.main()
    add(launches)
    require(got["launches"] == {"linreg_rss": got["iters"],
                                **tree_launches(got["iters"])},
            f"17d one rss_kernel launch (and one of each tree kernel) a "
            f"superstep: {got['launches']}")
    require(any("rss_kernel" in n for n, _ in got["top"]),
            "17d the trace names rss_kernel")
    print(json.dumps({"phase17d": {
        "wall_us_per_superstep": got["wall_us_per_iter"],
        "device_us_per_superstep": got["traced_us_per_iter"],
        "top": [(n[:80], us) for n, us in got["top"][:10]],
        "device": name, "power": smi}}))
    print(json.dumps({"phase17_reduced": [
        f"run_zoo MNIST num_steps {ZOO_MNIST_STEPS} (run_zoo's 2000)",
        f"queue MNIST-LSTM MH num_steps {Q_LSTM_STEPS} in chunks of "
        f"{Q_LSTM_CHUNK} (the paper's 1,000,000 in 5000), pretrain_steps "
        f"{Q_LSTM_PRETRAIN} (mnist's 50)",
        f"queue CIFAR SP-/PMP-HMC num_steps {Q_CIFAR_STEPS} in chunks of "
        f"{Q_CIFAR_CHUNK} (the paper's 50,000), pretrain_steps "
        f"{Q_CIFAR_PRETRAIN} (cifar_hmc's 30)",
        f"queue BNN SP-/PMP-HMC num_steps {Q_BNN_STEPS} in chunks of "
        f"{Q_BNN_CHUNK} (the paper's 30,000 in 1000)",
        f"queue ess_msjd on the fused kernel only, num_steps {Q_ESS_STEPS}, "
        f"burn_in {Q_ESS_BURN} (the paper's 1,000,000 and 2000), Ps 8,512",
    ], "launches": counts}))
    return counts

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1

    import pmpx_torch  # sets the f32 numerics
    here = Path(__file__).resolve().parent
    if Path(pmpx_torch.__file__).resolve().parent.parent != here:
        raise RuntimeError(f"pmpx_torch was imported from "
                           f"{pmpx_torch.__file__}, not from {here}")
    from pmpx_torch import _build, bench
    from pmpx_torch.config import SamplerSpec
    from pmpx_torch.data import load_mnist
    from pmpx_torch.experiments import ess_msjd, multichain, time_analysis
    from pmpx_torch.experiments import mnist as mnist_mod
    from pmpx_torch.kernels import fused_chain as fc
    from pmpx_torch.kernels import lstm_fused as lf
    from pmpx_torch.metrics.recorder import load_trace, reference_style_name
    from pmpx_torch.models import MnistLSTM, MnistMLP
    from pmpx_torch.samplers.base import compile_chain
    from pmpx_torch.targets.nn import NNPosterior
    from pmpx_torch.parallel import chains as farm_mod
    from pmpx_torch.kernels import launches, reset_launches
    from pmpx_torch.kernels.linreg import (
        batched_rss, batched_rss_ref, kernel_info, pad_proposals,
    )
    from pmpx_torch.samplers import pmp
    from pmpx_torch.targets.linreg import make_synthetic_linreg, pad_to_grid

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    with Phase("0 device"):
        name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = run_tool(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]).splitlines()[0]
        nvcc = run_tool([_build.nvcc_path(), "--version"]).splitlines()[-1]
        print(f"device: {name} x{count}; nvidia-smi: {smi}")
        print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
              f"python {sys.version.split()[0]}; nvcc: {nvcc}")

    with Phase("1 build"):
        built = _build.load()
        when = ("by an earlier run" if built.seconds is None
                else f"in {built.seconds:.3f} s")
        print(f"library {built.path.name}: built {when}")
        for line in built.log.splitlines():
            if "ptxas" in line or "spill" in line or "Used" in line:
                print("  " + line.strip())
        usage = ptxas_usage(built.log)
        for mode in ("binary", "mp", "general"):
            for tf in ("false", "true"):
                require(any(k.startswith(f"chain_{mode}_kernel<{tf}")
                            for k in usage),
                        f"ptxas reported chain_{mode}_kernel<{tf}>")
        for part in ("positions", "select", "gather"):
            require(f"tree_{part}_kernel" in usage,
                    f"ptxas reported tree_{part}_kernel")
        require(any("mamba2_ssd_kernel" in k for k in usage),
                "ptxas reported mamba2_ssd_kernel")
        for label, use in usage.items():
            print(f"{label}: {use['registers']} registers, "
                  f"{use['smem_bytes']} bytes of static shared memory, 0 "
                  f"dynamic (none asked at launch)")
        # the gate products of lstm_fused on the tensor cores: TF32 HGMMA
        # (wgmma) in the f32 instantiation, BF16 HMMA (mma.sync) in bf16
        mma = lstm_sass_mma(built.path)
        print(f"lstm_fused_kernel SASS: {json.dumps(mma)}")
        for tag, kind in (("float", ".TF32"), ("bfloat16", ".BF16")):
            got = mma.get(tag, {"hmma": 0, "hgmma": 0, "opcodes": []})
            require(got["hmma"] + got["hgmma"] > 0
                    and all(kind in op for op in got["opcodes"]),
                    f"tensor-core {kind[1:]} MMA in lstm_fused_kernel<{tag}>")
        # linreg_rss's launch at the sweep paths' n = 100,000: one cluster
        # launch whose blocks are all resident at once, one per SM
        for P_r in (1024, 512, 8):
            info = kernel_info(P_r, 100_000)
            print(f"rss_kernel at P={P_r}, n=100000: "
                  f"{info['registers']} registers, "
                  f"{info['static_smem_bytes']} bytes of static shared "
                  f"memory, {info['dynamic_smem_bytes']} dynamic; "
                  f"{info['clusters']} clusters of {info['cluster_size']} "
                  f"blocks of {info['threads']} threads, "
                  f"cudaOccupancyMaxActiveClusters {info['max_clusters']}, "
                  f"{info['blocks_per_sm']} block(s) an SM, "
                  f"{info['sms']} SMs")
            require(info["blocks_per_sm"] == 1
                    and info["clusters"] <= info["max_clusters"],
                    f"linreg_rss P={P_r}: one wave, one block an SM")
            if P_r >= 512:
                require(info["clusters"] * info["cluster_size"] >= 128,
                        f"linreg_rss P={P_r} on >= 128 SMs")

    with Phase("2 linreg_rss vs plain"):
        rss_err = 0.0

        def rss_case(P, n, seed, valid):
            """(max|err|, max|rss|) of the kernel against its plain version
            over every padded slot, or the first n points with ``valid``."""
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            x, y = make_synthetic_linreg(gen, n)
            x2d, y2d = pad_to_grid(x), pad_to_grid(y)
            b0 = -1.0 + 0.3 * torch.randn(P, generator=gen, device=dev)
            b1 = 2.0 + 0.3 * torch.randn(P, generator=gen, device=dev)
            b0p, b1p, _ = pad_proposals(b0, b1)
            kw = {"n_valid": n} if valid else {}
            got = batched_rss(b0p, b1p, x2d, y2d, **kw)
            want = batched_rss_ref(b0p, b1p, x2d, y2d, **kw)
            torch.cuda.synchronize()
            return ((got - want).abs().max().item(),
                    want.abs().max().item(), b0p.shape[0], x2d.numel())

        for P, n in RSS_SHAPES:
            for valid in (False, True):
                err, scale, Pp, slots = rss_case(P, n, 100 + P, valid)
                print(f"P={P} (padded {Pp}), n={n} ({slots} slots, "
                      f"{n if valid else slots} read): max|err| {err:.6g}, "
                      f"max|rss| {scale:.6g}, rel {err / scale:.3g}")
                require(err <= RSS_TOL * scale,
                        f"linreg_rss P={P} n={n} n_valid={valid}")
                rss_err = max(rss_err, err)
        worst = (0.0, None)
        for P in RSS_EDGE_P:
            for n in RSS_EDGE_N:
                for valid in (False, True):
                    err, scale, _, _ = rss_case(P, n, 1000 + P + n, valid)
                    require(err <= RSS_TOL * scale,
                            f"linreg_rss edge P={P} n={n} n_valid={valid}")
                    worst = max(worst, (err / scale, (P, n, valid)))
        print(f"edges: {len(RSS_EDGE_P) * len(RSS_EDGE_N) * 2} cases, "
              f"largest max|err|/max|rss| {worst[0]:.3g} at (P, n, n_valid) "
              f"{worst[1]}")

    with Phase("2b pmp_tree vs plain"):
        tree_rows = phase2b(dev, bench)

    with Phase("2c granite kernels vs plain"):
        phase2c(dev)

    target = bench.bench_target(dev)
    cfg = bench.bench_config()
    P, depth = cfg.P, cfg.depth
    L = fc.lane_extent(P)
    consts = dict(P=P, depth=depth, n_data=float(target.n),
                  temper=target.temper, step_size=cfg.step_size)

    # max |err| of the state, per mode, over phases 3, 3b and 3c
    mode_err = {"binary": 0.0, "mp": 0.0, "general": 0.0}

    with Phase("3 fused_chain vs plain"):
        mode_err["binary"] = chain_vs_plain(
            fc, "fused_chain", target, bench.theta0(dev), consts, seed=3)

    with Phase("3b fused_chain mp and general vs plain"):
        for N, d in NEW_MODES:
            mode = "mp" if d == 1 else "general"
            kw = dict(consts, P=(N + 1) ** d, depth=d, mode=mode, N=N,
                      trans_sigma=cfg.trans_sigma, trans_norm=1.0)
            err = chain_vs_plain(fc, f"fused_chain_{mode} N={N} depth={d}",
                                 target, bench.theta0(dev), kw,
                                 seed=30 + N + d)
            mode_err[mode] = max(mode_err[mode], err)

    # the ESS protocol's target (phases 3c-3e, 6 and 9): n = 100,000,
    # temper 1/2000, the data run() draws from seed 0
    et = ess_msjd.ess_target(ESS_N, device=dev)

    with Phase("3c the time grid's and the ESS protocol's fused cells vs "
               "plain"):
        for n in (500, 100_000):
            gt = time_analysis.grid_target(n, device=dev)
            for N, d in GRID_FUSED:
                spec = SamplerSpec(algo="mp" if d == 1 else "pmp", N=N,
                                   depth=d, step_size=0.02,
                                   selection="all_first")
                kw = fc.chain_consts(gt, fc.spec_to_cfg(spec))
                err = chain_vs_plain(
                    fc, f"{fc.KERNEL_NAME[kw['mode']]} N={N} depth={d} "
                    f"n={n}", gt, bench.theta0(dev), kw, seed=n + N + d)
                mode_err[kw["mode"]] = max(mode_err[kw["mode"]], err)
        for N, d in ESS_FUSED:
            kw = fc.chain_consts(et, pmp.PMPConfig(
                N=N, depth=d, step_size=0.02, selection="all_first"))
            err = chain_vs_plain(
                fc, f"{fc.KERNEL_NAME[kw['mode']]} N={N} depth={d} "
                f"n={ESS_N} (ESS target)", et, bench.theta0(dev), kw,
                seed=3000 + N + d)
            mode_err[kw["mode"]] = max(mode_err[kw["mode"]], err)
    # max |err| of the state per emit="all" mode (phase 3d)
    emit_err = {"binary": 0.0, "mp": 0.0, "general": 0.0}

    with Phase("3d fused_chain emit='all' vs plain"):
        for N, d in EMIT_SHAPES:
            ecfg = pmp.PMPConfig(N=N, depth=d, step_size=0.02,
                                 selection="all_first")
            kw = fc.chain_consts(et, ecfg)
            gen = torch.Generator(device=dev)
            gen.manual_seed(300 + N + d)
            L_e = fc.lane_extent(kw["P"])
            uin = 1.0 - torch.rand((2, 100 * fc.U_ROWS, L_e), generator=gen,
                                   device=dev)
            uemit = 1.0 - torch.rand((2, 100, L_e), generator=gen,
                                     device=dev)
            out = fc.replay_emit_against_plain(
                et.x2d, et.y2d, bench.theta0(dev), uin, uemit, **kw)
            label = f"{fc.KERNEL_NAME_ALL[kw['mode']]} N={N} depth={d}"
            for miss in out["misses"][:5]:
                print(f"{label}: step {miss[0]} slot {miss[1]}: plain draws "
                      f"node {miss[2]}, kernel {miss[3]}")
            print(f"{label} (P={kw['P']}): {out['slots_agree']}/"
                  f"{out['slots']} slot draws agree over 200 supersteps; "
                  f"max|err| of the states {out['state_err']:.3g}, of the "
                  f"jump sums {out['jump_err']:.3g} (relative to "
                  f"max(1, J)); slot 0 b0 bit-equal to the state's: "
                  f"{out['b0_root_equal']}")
            require(out["slots_agree"] >= CHAIN_AGREE * out["slots"],
                    f"{label} slot draws")
            require(out["state_err"] <= CHAIN_ATOL, f"{label} states")
            require(out["jump_err"] <= CHAIN_ATOL, f"{label} jump sums")
            require(out["b0_root_equal"], f"{label} emit_b0[0] == root b0")
            emit_err[kw["mode"]] = max(emit_err[kw["mode"]],
                                       out["state_err"])

    with Phase("3e chain farm vs single chains and plain"):
        th_farm = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 2.0, 0.5],
                                [0.5, -0.5, 1.5], [-2.0, 1.0, 0.8]],
                               device=dev)[:FARM_C]
        for N, d in FARM_SHAPES:
            fcfg = pmp.PMPConfig(N=N, depth=d, step_size=0.02,
                                 selection="all_first")
            farm = farm_mod.make_chain_farm_fused(et, fcfg, 1000, chunk=500)
            got = farm(farm_mod.chain_generators(11, FARM_C, dev), th_farm)
            single = fc.make_fused_chain(et, fcfg, chunk=500)
            gens = farm_mod.chain_generators(11, FARM_C, dev)
            for c in range(FARM_C):
                require(torch.equal(got[c], single(gens[c], th_farm[c], 1000)),
                        f"farm chain {c} of N={N} depth={d} bit-equal to "
                        f"its single chain")
            require(bool(torch.isfinite(got).all()), "finite farm roots")
            print(f"farm of {FARM_C} chains, N={N} depth={d} "
                  f"(P={fcfg.P}), 2 launches of 500 supersteps: every chain "
                  f"bit-equal to its single-chain run")
        # phase 9's farm cell at its own shape, on injected uniforms
        fcfg = pmp.PMPConfig(N=1, depth=9, step_size=0.02,
                             selection="all_first")
        th_cell = bench.theta0(dev).expand(ESS_CHAINS, 3).contiguous()
        farm_err = farm_vs_plain(fc, farm_mod, "farm", et, fcfg, th_cell, 39)
        # phase 11's multichain sweep cells, from its overdispersed starts
        mt = multichain.chain_target(MC_N, device=dev)
        th_mc = multichain.overdispersed(0, FARM_C, dev)
        for N, d in MC_FARM_SHAPES:
            mcfg = pmp.PMPConfig(N=N, depth=d, step_size=MC_STEP,
                                 selection="all_first")
            farm_err = max(farm_err, farm_vs_plain(
                fc, farm_mod, f"multichain farm N={N} depth={d}", mt, mcfg,
                th_mc, 50 + N + d))

    # the MNIST protocol's data (phases 3f, 6 and 10): the synthetic
    # stand-in at the paper's 60,000 / 10,000 images, as mnist.run draws it
    mn = dict(zip(("x_train", "y_train", "x_test", "y_test"),
                  load_mnist(device=dev)))

    def lstm_posterior(split="train", dtype=None):
        return NNPosterior(MnistLSTM(), mn[f"x_{split}"], mn[f"y_{split}"],
                           temper=10.0, device=dev, compute_dtype=dtype)

    def time_major(post):
        return post.X.reshape(-1, 28, 28).transpose(0, 1).contiguous()

    lstm_h_err = 0.0  # max |dh| in f32 over phase 3f's shapes

    with Phase("3f lstm_fused vs plain"):
        for dtype in (torch.float32, torch.bfloat16):
            posts = {split: lstm_posterior(split, dtype)
                     for split in ("train", "test")}
            for P_l, split in LSTM_SHAPES:
                post = posts[split]
                gen = torch.Generator(device=dev)
                gen.manual_seed(40 + P_l)
                Theta = post.init_theta() + 0.05 * torch.randn(
                    (P_l, post.d), generator=gen, device=dev)
                x_tm, W = time_major(post), lf.gate_weights(post, Theta)
                before = launches["lstm_fused"]
                h_k = lf.lstm_final_hidden(x_tm, *W)
                require(launches["lstm_fused"] == before + 1,
                        "lstm_fused launched once")
                dh = (h_k - lf.lstm_final_hidden_ref(x_tm, *W)).abs().max()
                lp_k = lf.make_fast_log_prob_batch(post)(Theta)
                lp_p = lf.make_fast_log_prob_batch(
                    post, hidden=lf.lstm_final_hidden_ref)(Theta)
                rel = ((lp_k - lp_p).abs() / lp_p.abs()).max().item()
                label = (f"lstm_fused {str(dtype)[6:]} P={P_l} "
                         f"B={x_tm.shape[1]}")
                print(f"{label}: max|dh| {dh.item():.3g}, log-densities "
                      f"{lp_k.tolist()} against plain {lp_p.tolist()}, max "
                      f"rel {rel:.3g}")
                require(bool(torch.isfinite(h_k).all()), f"{label} finite")
                if dtype == torch.float32:
                    lstm_h_err = max(lstm_h_err, dh.item())
                    require(dh.item() <= LSTM_H_TOL, f"{label} |dh|")
                    require(rel <= LSTM_LP_RTOL, f"{label} log-densities")
                else:
                    require(torch.allclose(lp_k, lp_p, rtol=LSTM_BF16_RTOL,
                                           atol=LSTM_BF16_ATOL),
                            f"{label} log-densities")
            del posts
        # the replay: PMP supersteps of the protocol at full batch
        post = lstm_posterior()
        lf.attach(post)
        rcfg = pmp.PMPConfig(N=1, depth=3, step_size=1e-4,
                             selection="single", stabilizer="zscore")
        gen = torch.Generator(device=dev)
        gen.manual_seed(41)
        eps = 1e-4 * torch.randn((LSTM_REPLAY, rcfg.P, post.d),
                                 generator=gen, device=dev)
        u = torch.rand((LSTM_REPLAY, 1), generator=gen, device=dev)
        agree, err = lf.replay_against_plain(post, rcfg, post.init_theta(),
                                             eps, u)
        print(f"lstm PMP replay (P=8, B=60000): {agree}/{LSTM_REPLAY} "
              f"selections agree; max|err| of the state where they do: "
              f"{err:.3g}")
        require(agree >= CHAIN_AGREE * LSTM_REPLAY, "lstm replay selections")
        require(err == 0.0, "lstm replay states bit-equal")
        del post, eps

    with Phase("4 sweep main path"):
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        th0 = bench.theta0(dev)
        chain = compile_chain(pmp.make_superstep(target, cfg), gen, th0,
                              bench._theta)
        chain.run(gen, th0, 20)  # the captures, before the count
        reset_launches()
        _, sweep_trace = chain.run(gen, th0, SWEEP_PATH_STEPS)
        sweep_counts = dict(launches)
        print(f"sweep: launches {sweep_counts}")
        require(sweep_counts["linreg_rss"] == SWEEP_PATH_STEPS,
                "one linreg_rss launch per superstep")
        require({k: sweep_counts[k] for k in tree_launches(0)}
                == tree_launches(SWEEP_PATH_STEPS),
                "one launch of each tree kernel per superstep")
        posterior_check("sweep", sweep_trace, SWEEP_BURN, target, bench)

    with Phase("5 fused main path"):
        run = fc.make_fused_chain(target, cfg, chunk=FUSED_CHUNK)
        gen.manual_seed(2)
        run(gen, th0, FUSED_CHUNK)
        reset_launches()
        fused_trace = run(gen, th0, FUSED_STEPS)
        fused_counts = dict(launches)
        print(f"fused: launches {fused_counts}")
        require(fused_counts["fused_chain"] == FUSED_STEPS // FUSED_CHUNK,
                "one fused_chain launch per chunk")
        posterior_check("fused", fused_trace, FUSED_BURN, target, bench)

    with Phase("6 kernel times"):
        kernels = []
        for row in tree_rows:
            row["launches"] = sweep_counts[row["name"]]
            kernels.append(row)
        # linreg_rss at the sweep's shape: P = 1024 positions of one tree
        g = torch.Generator(device=dev)
        g.manual_seed(6)
        th = sweep_trace[-1]
        b0 = (th[0] + 0.05 * torch.randn(P, generator=g, device=dev))
        b1 = (th[1] + 0.05 * torch.randn(P, generator=g, device=dev))
        x2d, y2d = target.x2d, target.y2d
        # the sweep's call reads the n real points; the padded contract
        # (every slot) beside it.  ms: the device's time (a CUDA graph of
        # 200 calls), the eager 200-call figure and the host's us beside it
        rss_t = bench.rss_times(b0, b1, x2d, y2d, n_valid=target.n)
        rss_pad = bench.rss_times(b0, b1, x2d, y2d)
        print(f"linreg_rss P={P}: n_valid={target.n} {json.dumps(rss_t)}; "
              f"every slot {json.dumps(rss_pad)}")
        # counted in a CUDA graph of one call: a profiler trace may drop a
        # kernel's record (199 of 200 after the sweep, on an H100)
        for t in (rss_t, rss_pad):
            require(t["kernels_per_call"] == 1
                    and t["other_nodes_per_call"] == 0
                    and t["own_kernels"] == ["rss_kernel"],
                    "one CUDA kernel a linreg_rss call")
        plain_ms = event_ms(lambda: batched_rss_ref(
            b0, b1, x2d, y2d, n_valid=target.n), 5)
        b_ms, b_by = bound(5.0 * P * target.n,
                           4.0 * (2 * target.n + 3 * P))
        b_pad, _ = bound(5.0 * P * x2d.numel(),
                         4.0 * (2 * x2d.numel() + 3 * P))
        kernels.append({
            "name": "linreg_rss", "route": "cuda",
            "source": "pmpx_torch/csrc/linreg_rss.cu",
            "replaces": "pmpx/kernels/linreg.py:54",
            "launches": sweep_counts["linreg_rss"],
            "max_abs_err": rss_err,
            "ms": rss_t["device_us"] / 1e3, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "busy_ms": rss_t["busy_us"] / 1e3,
            "eager_ms": rss_t["eager_us"] / 1e3,
            "host_us": rss_t["host_us"], "points_read": target.n,
            "ms_every_slot": rss_pad["device_us"] / 1e3,
            "bound_ms_every_slot": b_pad, "P": P,
            "geometry": kernel_info(P, target.n),
        })

        # fused_chain: one launch of the fused path's chunk
        chunk = FUSED_CHUNK
        seed = torch.tensor([12345], dtype=torch.int32, device=dev)
        th0 = bench.theta0(dev)
        ms = event_ms(lambda: fc.chain_chunk(
            x2d, y2d, th0, steps=chunk, seed=seed, **consts), 5)
        uin1 = 1.0 - torch.rand((chunk * fc.U_ROWS, L), generator=g,
                                device=dev)
        ms_input = event_ms(lambda: fc.chain_chunk(
            x2d, y2d, th0, steps=chunk, uin=uin1, **consts), 5)
        plain_ms = event_ms(lambda: fc.fused_chain_ref(
            x2d, y2d, th0, uin1, **consts), 1)
        cb = chain_sm_bound("binary", "root", P, chunk, target.n, depth=depth)
        cbi = chain_sm_bound("binary", "root", P, chunk, target.n,
                             depth=depth, rng="input")
        kernels.append({
            "name": "fused_chain", "route": "cuda",
            "source": "pmpx_torch/csrc/fused_chain.cu",
            "replaces": "pmpx/kernels/fused_chain.py:184",
            "launches": fused_counts["fused_chain"],
            "max_abs_err": mode_err["binary"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": cb["bound_ms"],
            "bound_by": cb["bound_by"], "library_ms": None,
            "ms_rng_input": ms_input,
            "bound_ms_rng_input": cbi["bound_ms"],
            "bound_by_rng_input": cbi["bound_by"],
            "steps_per_launch": chunk, "P": P,
        })
        # fused_chain_mp and fused_chain_general: one launch of the same
        # chunk at the grid's flat P = 1024 and conv_pmp's P = 512 tree
        for kname, N_k, d_k in (("fused_chain_mp", 1023, 1),
                                ("fused_chain_general", 7, 3)):
            mode = "mp" if d_k == 1 else "general"
            kw = dict(consts, P=(N_k + 1) ** d_k, depth=d_k, mode=mode,
                      N=N_k, trans_sigma=cfg.trans_sigma, trans_norm=1.0)
            uin_k = 1.0 - torch.rand((chunk * fc.U_ROWS,
                                      fc.lane_extent(kw["P"])),
                                     generator=g, device=dev)
            ms = event_ms(lambda kw=kw: fc.chain_chunk(
                x2d, y2d, th0, steps=chunk, seed=seed, **kw), 5)
            ms_input = event_ms(lambda kw=kw, u=uin_k: fc.chain_chunk(
                x2d, y2d, th0, steps=chunk, uin=u, **kw), 5)
            plain_ms = event_ms(lambda kw=kw, u=uin_k: fc.fused_chain_ref(
                x2d, y2d, th0, u, **kw), 1)
            cb, cbi = (chain_sm_bound(mode, "root", kw["P"], chunk, target.n,
                                      N=N_k, depth=d_k, rng=r)
                       for r in ("kernel", "input"))
            kernels.append({
                "name": kname, "route": "cuda",
                "source": "pmpx_torch/csrc/fused_chain.cu",
                "replaces": "pmpx/kernels/fused_chain.py:184",
                "launches": None,  # from the time grid, phase 7
                "max_abs_err": mode_err[mode],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": cb["bound_ms"],
                "bound_by": cb["bound_by"], "library_ms": None,
                "ms_rng_input": ms_input,
                "bound_ms_rng_input": cbi["bound_ms"],
                "bound_by_rng_input": cbi["bound_by"],
                "steps_per_launch": chunk, "P": kw["P"],
            })
        # emit="all" at the ESS protocol's largest P = 512, one
        # 1000-superstep launch on its target, beside emit="root" at the
        # same shape
        steps_e = 1000
        for kname, N_k, d_k in (("fused_chain_all", 1, 9),
                                ("fused_chain_mp_all", 511, 1),
                                ("fused_chain_general_all", 7, 3)):
            kw = fc.chain_consts(et, pmp.PMPConfig(
                N=N_k, depth=d_k, step_size=0.02, selection="all_first"))
            P_k = kw["P"]
            L_k = fc.lane_extent(P_k)
            uin_k = 1.0 - torch.rand((steps_e * fc.U_ROWS, L_k),
                                     generator=g, device=dev)
            uem_k = 1.0 - torch.rand((steps_e, L_k), generator=g,
                                     device=dev)
            ms = event_ms(lambda kw=kw: fc.chain_chunk(
                et.x2d, et.y2d, th0, steps=steps_e, seed=seed, emit="all",
                **kw), 5)
            ms_root = event_ms(lambda kw=kw: fc.chain_chunk(
                et.x2d, et.y2d, th0, steps=steps_e, seed=seed, **kw), 5)
            ms_input = event_ms(lambda kw=kw, u=uin_k, e=uem_k:
                                fc.chain_chunk(et.x2d, et.y2d, th0,
                                               steps=steps_e, uin=u,
                                               uemit=e, emit="all", **kw), 5)
            plain_ms = event_ms(lambda kw=kw, u=uin_k, e=uem_k:
                                fc.fused_chain_ref(et.x2d, et.y2d, th0, u,
                                                   uemit=e, **kw), 1)
            cb, cbi = (chain_sm_bound(kw["mode"], "all", P_k, steps_e,
                                      et.n, N=N_k, depth=d_k, rng=r)
                       for r in ("kernel", "input"))
            kernels.append({
                "name": kname, "route": "cuda",
                "source": "pmpx_torch/csrc/fused_chain.cu",
                "replaces": "pmpx/kernels/fused_chain.py:348",
                "launches": None,  # from the ESS protocol, phase 9
                "max_abs_err": emit_err[kw["mode"]],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": cb["bound_ms"],
                "bound_by": cb["bound_by"], "library_ms": None,
                "ms_rng_input": ms_input,
                "bound_ms_rng_input": cbi["bound_ms"],
                "bound_by_rng_input": cbi["bound_by"],
                "ms_emit_root": ms_root, "steps_per_launch": steps_e,
                "P": P_k,
            })

        # the farm: ESS_CHAINS chains of binary P = 512 in one
        # 1000-superstep launch (phase 9's farm cell), beside its plain
        # version (each chain's plain loop)
        kw = fc.chain_consts(et, pmp.PMPConfig(
            N=1, depth=9, step_size=0.02, selection="all_first"))
        thC = bench.theta0(dev).expand(ESS_CHAINS, 3).contiguous()
        seedsC = torch.arange(ESS_CHAINS, dtype=torch.int32, device=dev)
        ms = event_ms(lambda: fc.chain_chunk(
            et.x2d, et.y2d, thC, steps=steps_e, seed=seedsC, **kw), 5)
        uinC = 1.0 - torch.rand((ESS_CHAINS, steps_e * fc.U_ROWS, 512),
                                generator=g, device=dev)
        plain_ms = event_ms(lambda: [fc.fused_chain_ref(
            et.x2d, et.y2d, thC[c], uinC[c], **kw)
            for c in range(ESS_CHAINS)], 1, warmup=False)
        cb = chain_sm_bound("binary", "root", 512, steps_e, et.n,
                            depth=9, chains=ESS_CHAINS)
        kernels.append({
            "name": "fused_chain_farm", "route": "cuda",
            "source": "pmpx_torch/csrc/fused_chain.cu",
            "replaces": "pmpx/kernels/fused_chain.py:184",
            "farm_of": "pmpx/parallel/chains.py:83",
            "launches": None,  # from the ESS protocol's farm cell, phase 9
            "max_abs_err": farm_err,  # against plain, phase 3e
            "ms": ms, "plain_ms": plain_ms, "bound_ms": cb["bound_ms"],
            "bound_by": cb["bound_by"], "library_ms": None,
            "steps_per_launch": steps_e, "P": 512, "chains": ESS_CHAINS,
        })

        # the farm's throughput: supersteps per second of the whole card
        # against the chain count, one 1000-superstep launch each
        farm_curve = []
        for N_k, d_k in ((1, 3), (1, 9)):
            kw = fc.chain_consts(et, pmp.PMPConfig(
                N=N_k, depth=d_k, step_size=0.02, selection="all_first"))
            for C in FARM_COUNTS:
                thC = bench.theta0(dev).expand(C, 3).contiguous()
                seedsC = torch.arange(C, dtype=torch.int32, device=dev)
                ms = event_ms(lambda kw=kw, t=thC, sd=seedsC: fc.chain_chunk(
                    et.x2d, et.y2d, t, steps=steps_e, seed=sd, **kw), 3)
                farm_curve.append({
                    "P": kw["P"], "chains": C, "ms_per_launch": ms,
                    "supersteps_per_s": C * steps_e / (ms * 1e-3)})
                print(f"farm P={kw['P']} C={C}: {ms:.6g} ms per "
                      f"{steps_e}-superstep launch, "
                      f"{C * steps_e / (ms * 1e-3):.6g} supersteps/s")
        print(json.dumps({"farm_throughput": farm_curve, "device": name,
                          "power": smi}))

        # each chain kernel's µs per superstep against P on the benchmark
        # cell's data
        sweep = chain_p_sweep(target, th0, seed)
        print(json.dumps({"p_sweep": sweep["rows"], "fits": sweep["fits"],
                          "device": name, "power": smi}))
        # where a superstep's clocks go: the stamped chain library
        stamped = _build.load(stamps=True)
        print(f"stamped library {stamped.path.name}: built "
              + ("by an earlier run" if stamped.seconds is None
                 else f"in {stamped.seconds:.3f} s"))
        for label, use in ptxas_usage(stamped.log).items():
            print(f"stamped {label}: {use['registers']} registers, "
                  f"{use['smem_bytes']} bytes of static shared memory")
        splits = stamp_splits(target, th0, seed)
        print(json.dumps({"stamp_splits": splits, "device": name,
                          "power": smi}))

        # lstm_fused at the MNIST protocol's P = 8 over the 60,000 images,
        # beside P calls of cuDNN's LSTM with the same weights (bias_ih 0,
        # TF32 off), a yardstick the port never calls
        post = lstm_posterior()
        g.manual_seed(60)
        Theta = post.init_theta() + 0.05 * torch.randn(
            (8, post.d), generator=g, device=dev)
        x32, W32 = time_major(post), lf.gate_weights(post, Theta)
        x16 = x32.bfloat16()
        W16 = (W32[0].bfloat16(), W32[1].bfloat16(), W32[2])
        ms = event_ms(lambda: lf.lstm_final_hidden(x32, *W32), 10)
        ms_bf16 = event_ms(lambda: lf.lstm_final_hidden(x16, *W16), 10)
        plain_ms = event_ms(lambda: lf.lstm_final_hidden_ref(x32, *W32), 3)
        plain_ms_bf16 = event_ms(
            lambda: lf.lstm_final_hidden_ref(x16, *W16), 3)

        def cudnn_lstms(dtype, flat=True):
            """8 torch LSTMs in ``dtype`` holding the kernel's 8 weight
            sets in torch's layout, each module's weights in one buffer
            unless ``flat`` is False.  flatten_parameters() returns early
            for bf16 (torch.backends.cudnn.is_acceptable takes half, float
            and double only), so cuDNN warns and compacts the weights at
            every call; the same flattening is called here directly."""
            import torch.backends.cudnn.rnn as cudnn_rnn

            mods = []
            for p in range(8):
                m = torch.nn.LSTM(28, 64, device=dev, dtype=dtype)
                with torch.no_grad():
                    m.weight_ih_l0.copy_(W32[0][p].T)
                    m.weight_hh_l0.copy_(W32[1][p].T)
                    m.bias_hh_l0.copy_(W32[2][p])
                    m.bias_ih_l0.zero_()
                    if flat:
                        torch._cudnn_rnn_flatten_weight(
                            m._flat_weights, 4, m.input_size,
                            cudnn_rnn.get_cudnn_mode(m.mode), m.hidden_size,
                            m.proj_size, m.num_layers, m.batch_first,
                            bool(m.bidirectional))
                mods.append(m)
            return mods

        lib, lib_warn = {}, {}
        with torch.no_grad():
            for label, dtype, x, flat in (
                    ("float32", torch.float32, x32, True),
                    ("bfloat16", torch.bfloat16, x16, True),
                    ("bfloat16_compacting", torch.bfloat16, x16, False)):
                mods = cudnn_lstms(dtype, flat)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    lib[label] = event_ms(
                        lambda mods=mods, x=x: [m(x)[1][0] for m in mods], 10)
                lib_warn[label] = sorted(
                    {str(w.message)[:80] for w in caught})
            h_lib = torch.stack([m(x32)[1][0][0]
                                 for m in cudnn_lstms(torch.float32)])
            h_lib16 = torch.stack([m(x16)[1][0][0].float()
                                   for m in cudnn_lstms(torch.bfloat16)])
        lib_err = (h_lib - lf.lstm_final_hidden(x32, *W32)).abs().max().item()
        print(f"lstm_fused: cuDNN's f32 h_T against the kernel's (the same "
              f"weights through torch's LSTM layout): max|dh| {lib_err:.3g}; "
              f"cuDNN's warnings while timed: {lib_warn}")
        require(lib_err <= LSTM_LIB_TOL, "cuDNN's h_T against the kernel's")
        require(not lib_warn["bfloat16"], "cuDNN's bf16 weights flattened")
        # cuDNN's bf16 LSTM rounds its own sums and h; a sanity check only
        lib_err16 = (h_lib16 - lf.lstm_final_hidden(x16, *W16)).abs().max()
        print(f"lstm_fused: cuDNN's bf16 h_T against the kernel's: max|dh| "
              f"{lib_err16.item():.3g}")
        lib_ms, lib_ms_bf16 = lib["float32"], lib["bfloat16"]
        bd = lstm_fused_bound()
        print(f"lstm_fused bounds (P=8, B=60000): {json.dumps(bd)}")
        kernels.append({
            "name": "lstm_fused", "route": "cuda",
            "source": "pmpx_torch/csrc/lstm_fused.cu",
            "replaces": "pmpx/kernels/lstm_fused.py:48",
            "launches": None,  # from the MNIST path, phase 10
            "max_abs_err": lstm_h_err,  # f32 h_T against plain, phase 3f
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bd["bound_ms"],
            "bound_by": "operations", "library_ms": lib_ms,
            "ms_bf16": ms_bf16, "plain_ms_bf16": plain_ms_bf16,
            "library_ms_bf16": lib_ms_bf16,
            "library_ms_bf16_compacting": lib["bfloat16_compacting"],
            "library_warnings": lib_warn,
            "bound_ms_bf16": bd["bound_ms_bf16"],
            "bound_ms_f32_cuda_cores": bd["bound_ms_f32"],
            "bound_ms_3xtf32": bd["bound_ms_3xtf32"],
            "bound_ms_bf16_tensor": bd["bound_ms_bf16_tensor"],
            "transcendental_floor_ms": bd["transcendental_floor_ms"],
            "library_max_abs_diff": lib_err, "P": 8, "B": 60_000,
        })
        del post, h_lib, h_lib16

        for k in kernels:
            print(f"{k['name']}: {k['ms']:.6g} ms/launch, plain "
                  f"{k['plain_ms']:.6g} ms, bound {k['bound_ms']:.6g} ms "
                  f"({k['bound_by']})")

    with Phase("7 time grid"):
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            grid_sweep = time_analysis.run(method="sweep", out_dir=tmp,
                                           device=dev)
            grid_counts = {"linreg_rss": launches["linreg_rss"]}
            reset_launches()
            grid_fused = time_analysis.run(
                method="fused_chain", include_conv_pmp=True, out_dir=tmp,
                device=dev)
            grid_counts.update({k: launches[k]
                                for k in fc.KERNEL_NAME.values()})
        print(json.dumps({"time_analysis": "sweep", **grid_sweep}))
        print(json.dumps({"time_analysis": "fused_chain", **grid_fused}))
        print(f"launches in the grid: {grid_counts}")
        for kname, n in grid_counts.items():
            require(n > 0, f"the time grid launched {kname}")
        methods = {k: v for k, v in grid_fused.items()
                   if k.endswith("_method")}
        require(len(methods) == 10, "10 fused cells (2 sizes x 5)")
        require(set(methods.values()) == {"fused_chain"},
                f"every fused cell on fused_chain: {methods}")
        for key in ("mp_n100000_P1024_method",
                    "pmp_general_N7_D3_n100000_P512_method"):
            require(key in methods, key)
        for grid in (grid_sweep, grid_fused):
            for k, v in grid.items():
                if k.endswith("_us") and not k.endswith("overhead_us"):
                    require(math.isfinite(v) and v > 0, f"{k} = {v}")
        for k in kernels:
            if k["name"] in grid_counts:
                k["launches"] = grid_counts[k["name"]]

        # posterior check of a flat-MP and a general fused chain at the
        # grid's n = 100,000 (the bench cell's data and temper)
        for label, N_k, d_k in (("mp P=1024", 1023, 1),
                                ("general N=7 depth=3", 7, 3)):
            pcfg = pmp.PMPConfig(N=N_k, depth=d_k, step_size=0.02,
                                 selection="all_first")
            run = fc.make_fused_chain(target, pcfg, chunk=FUSED_CHUNK)
            gen = torch.Generator(device=dev)
            gen.manual_seed(7)
            trace = run(gen, bench.theta0(dev), POSTERIOR_STEPS)
            posterior_check(f"fused {label}", trace, POSTERIOR_BURN, target,
                            bench)

    with Phase("8 cores_sweep"):
        from pmpx_torch.experiments import cores_sweep

        cores = {}
        with tempfile.TemporaryDirectory() as tmp:
            for algo in ("pmp", "mp"):
                reset_launches()
                out = cores_sweep.run(
                    n_data=100_000, Ps=(4, 1024), set_time=CORES_SET_TIME,
                    algo=algo, method="fused_chain", out_dir=tmp,
                    device=dev)
                counts = {k: v for k, v in launches.items() if v}
                cores[algo] = {**out, "launches": counts}
                for P_k in (4, 1024):
                    require(out[f"P{P_k}_iters"] > 0
                            and math.isfinite(out[f"P{P_k}_err"]),
                            f"cores_sweep {algo} P={P_k}")
                require(counts.get("fused_chain_mp" if algo == "mp"
                                   else "fused_chain", 0) > 0,
                        f"cores_sweep {algo} went through its kernel")
        print(json.dumps({
            "cores_sweep": cores, "n_data": 100_000,
            "reduced": f"wall budget {CORES_SET_TIME} s per P (pmpx's "
                       "default 5 s, the reference's 180 s)",
        }))

    with Phase("9 ess_msjd"):
        ess_runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            def drive(label, **kw):
                """One run() of the protocol, its launches counted from 0."""
                reset_launches()
                out = ess_msjd.run(n_data=ESS_N, out_dir=f"{tmp}/{label}",
                                   device=dev, **kw)
                counts = {k: v for k, v in launches.items() if v}
                saved = load_trace(f"{tmp}/{label}/ess_msjd.npz")
                with open(f"{tmp}/{label}/ess_msjd.json") as fh:
                    cells = json.load(fh)["rows"]
                wall = dict(zip(cells, saved["rows"][:, 2].tolist()))
                ess_runs[label] = {"summary": out, "launches": counts}
                print(json.dumps({"ess_msjd": label, **out,
                                  "launches": counts, "wall_s": wall}))
                for k, v in out.items():
                    require(math.isfinite(v) and v > 0, f"{label}: {k} = {v}")
                return out, counts, saved

            fused = dict(Ps=ESS_PS, num_steps=ESS_STEPS, burn_in=ESS_BURN,
                         method="fused_chain")
            n_launch_all = 2 * len(ESS_PS) * ESS_STEPS // 500
            n_launch_root = 2 * len(ESS_PS) * ESS_STEPS // 1000
            _, counts, _ = drive("fused_all", trace="all", **fused)
            require(counts == {"fused_chain_all": n_launch_all,
                               "fused_chain_mp_all": n_launch_all},
                    f"the emit-all cells all on fused_chain: {counts}")
            _, counts, saved = drive("fused_root", trace="root", **fused)
            require(counts == {"fused_chain": n_launch_root,
                               "fused_chain_mp": n_launch_root},
                    f"the root cells all on fused_chain: {counts}")
            # the posterior mean of (b0, b1) at P = 512, both algorithms
            ls, sd = bench.least_squares(et)
            for i, algo in enumerate(("mp", "pmp")):
                row = i * len(ESS_PS) + ESS_PS.index(512)
                mean = torch.tensor(saved["root_mean"][row, :2])
                z = ((mean - ls) / sd).abs()
                print(f"ess_msjd {algo} P=512: posterior mean (b0, b1) = "
                      f"{mean.tolist()}, least squares = {ls.tolist()}, "
                      f"sd = {sd.tolist()}, |z| = {z.tolist()}")
                require(bool((z < 4.0).all()),
                        f"ess_msjd {algo} P=512 mean within 4 sd")
            _, counts, _ = drive("fused_chains8", trace="root",
                                 chains=ESS_CHAINS, algos=("pmp",),
                                 **dict(fused, Ps=(512,)))
            require(counts == {"fused_chain_farm": 2 * ESS_STEPS // 1000},
                    f"the farm cell in one launch per chunk: {counts}")
            _, counts, _ = drive("sweep_all", trace="all", method="sweep",
                                 Ps=ESS_SWEEP_PS, num_steps=ESS_SWEEP_STEPS,
                                 burn_in=ESS_SWEEP_BURN)
            require(set(counts) == {"linreg_rss", *tree_launches(0)}
                    and counts["pmp_tree_positions"]
                    == counts["pmp_tree_select"],
                    f"the superstep cells on linreg_rss, the binary ones "
                    f"on the tree kernels: {counts}")
            # the emit-all cell on conv_pmp's N = 7 x depth 3 tree (the
            # general mode; not in pmpx's P grid, which is binary and flat)
            reset_launches()
            gspec = SamplerSpec(algo="pmp", N=7, depth=3, step_size=0.02,
                                selection="all_first")
            res = ess_msjd._emit_all_cell_fused(
                et, gspec, bench.theta0(dev), ESS_STEPS, ESS_BURN, ESS_STEPS,
                f"{tmp}/general", 0, False, "pmp_general_N7_D3")
            counts = {k: v for k, v in launches.items() if v}
            root_e, root_m, all_e, all_m, dt = res
            print(f"general emit-all cell: {dt:.6g} s wall")
            out = {"pmp_general_N7_D3_P512_all_ess_per_s": all_e / dt,
                   "pmp_general_N7_D3_P512_all_msjd_per_s": all_m / dt,
                   "pmp_general_N7_D3_P512_ess_per_s": root_e / dt,
                   "pmp_general_N7_D3_P512_msjd_per_s": root_m / dt}
            ess_runs["general_all"] = {"summary": out, "launches": counts}
            print(json.dumps({"ess_msjd": "general_all", **out,
                              "launches": counts}))
            for k, v in out.items():
                require(math.isfinite(v) and v > 0, f"general: {k} = {v}")
            require(counts == {"fused_chain_general_all":
                               2 * ESS_STEPS // 500},
                    f"the general emit-all cell on fused_chain: {counts}")
        print(json.dumps({
            "ess_msjd_reduced": [
                f"num_steps {ESS_STEPS} with burn-in {ESS_BURN} (the "
                "paper's 1,000,000 and 2,000)",
                f"superstep-path emit-all cells only at P in "
                f"{list(ESS_SWEEP_PS)}, {ESS_SWEEP_STEPS} steps with burn-in "
                f"{ESS_SWEEP_BURN} (host-bound path)",
            ], "n_data": ESS_N}))
        phase9 = {"fused_chain_all": "fused_all",
                  "fused_chain_mp_all": "fused_all",
                  "fused_chain_general_all": "general_all",
                  "fused_chain_farm": "fused_chains8"}
        for k in kernels:
            if k["name"] in phase9:
                k["launches"] = ess_runs[phase9[k["name"]]]["launches"][
                    k["name"]]

    with Phase("10 mnist"):
        mnist_runs = {}
        with tempfile.TemporaryDirectory() as tmp:
            # the kernel-path density at the LSTM warm start (the Adam
            # pretrain of run()) against the generic path's
            tgt = lstm_posterior()
            th_ws = mnist_mod.pretrain(tgt, 50)
            with torch.no_grad():
                generic = tgt.log_prob(th_ws).item()
                lf.attach(tgt)
                kern = tgt.log_prob(th_ws).item()
            rel = abs(kern - generic) / abs(generic)
            print(f"LSTM warm start: kernel-path log-density {kern!r}, "
                  f"generic path {generic!r}, rel {rel:.3g}")
            require(rel <= LSTM_LP_RTOL, "kernel-path density at theta0")
            # where a superstep's time goes: a torch.profiler trace of
            # MNIST_PROFILE PMP supersteps (N = 7, alpha 1e-4) after a
            # warm-up, LSTM through the kernel and FC on the generic path
            fc_t = NNPosterior(MnistMLP(), mn["x_train"], mn["y_train"],
                               temper=10.0, device=dev)
            for label, t, th in (("LSTM_pmp", tgt, th_ws),
                                 ("FC_pmp", fc_t, fc_t.init_theta())):
                sup = mnist_mod.sampler_spec("pmp", 1e-4, 7).build(t)
                gen = torch.Generator(device=dev)
                gen.manual_seed(1)
                with torch.no_grad():
                    chain = compile_chain(sup, gen, th, lambda a, o: a)
                    chain.run(gen, th, MNIST_PROFILE)  # and the capture
                    prof = bench.profile_path(
                        lambda c=chain, th=th: c.run(gen, th, MNIST_PROFILE))
                print(json.dumps({"profile": f"mnist_{label}",
                                  "supersteps": MNIST_PROFILE, **prof}))
            # a chain's graphs hold a full-batch superstep's memory
            del tgt, fc_t, sup, chain
            for model, algo, steps in MNIST_CELLS:
                label = f"{model}_{algo}"
                kernel = model == "LSTM"
                reset_launches()
                # one loop, timed by CUDA events (chunk_steps=0; phase 12d
                # runs the checkpointed chunks)
                out = mnist_mod.run(model=model, algo=algo, N=7,
                                    scale="paper", num_steps=steps,
                                    lstm_kernel=kernel, chunk_steps=0,
                                    out_dir=f"{tmp}/{label}", device=dev)
                counts = {k: v for k, v in launches.items() if v}
                stem = reference_style_name(algo.upper(), 1e-4, steps,
                                            model=model, N=7)
                with open(f"{tmp}/{label}/{stem}.json") as fh:
                    meta = json.load(fh)
                losses = load_trace(f"{tmp}/{label}/{stem}.npz")["loss"]
                mnist_runs[label] = {"launches": counts, **out}
                print(json.dumps({
                    "mnist": label, "model": model, "algo": algo, "N": 7,
                    "lstm_kernel": kernel,
                    "us_per_superstep": meta["us_per_superstep"],
                    "chain_wall_s": meta["chain_wall_s"], "launches": counts,
                    **out, "num_steps": steps, "n_train": 60_000,
                    "n_test": 10_000,
                    "reduced": f"num_steps {steps} (the paper's "
                               f"{mnist_mod.PAPER_STEPS[model]:,})",
                    "device": name, "power": smi}))
                require(bool(np.isfinite(losses).all()), f"{label} losses")
                require(np.unique(losses).size > 1, f"{label}: chain moved")
                # FC's 567,434 parameters pass one block's copy
                tree = (tree_launches(steps, gather=model == "FC",
                                      inplace=model == "FC")
                        if algo == "pmp" else {})
                require(counts == ({"lstm_fused": steps} if kernel else {})
                        | tree, f"{label}: one lstm_fused launch per "
                        f"superstep, and the binary tree's kernels: {counts}")
        for k in kernels:
            if k["name"] == "lstm_fused":
                k["launches"] = sum(r["launches"].get("lstm_fused", 0)
                                    for r in mnist_runs.values())

    with Phase("11 linreg and analytic experiments"):
        from pmpx_torch import runtime
        from pmpx_torch.experiments import (
            banana, convergence, correlation, error_boxplot, lb_grid,
            skewness,
        )

        p11 = {}  # this phase's launches, by kernel
        with tempfile.TemporaryDirectory() as tmp:
            def drive(label, mod, **kw):
                """One run() of an experiment, its launches counted from 0
                and added to the phase's."""
                reset_launches()
                t0 = time.perf_counter()
                out = mod.run(out_dir=f"{tmp}/{label}", device=dev, **kw)
                wall = time.perf_counter() - t0
                counts = {k: v for k, v in launches.items() if v}
                for k, v in counts.items():
                    p11[k] = p11.get(k, 0) + v
                shown = {k: v for k, v in out.items() if k != "rows"}
                print(json.dumps({"experiment": label, **shown,
                                  "wall_s": wall, "launches": counts,
                                  "device": name, "power": smi}))
                return out, counts

            # convergence: the conv_*.cu protocol at n = 100,000, nothing
            # cut; a warm-up and a timed run per algorithm
            out, counts = drive("convergence", convergence, scale="paper",
                                method="sweep")
            require(counts == {"linreg_rss": 2 * 3 * 3000},
                    f"convergence: one linreg_rss launch a superstep: "
                    f"{counts}")
            # convergence draws the ESS protocol's data and temper (et),
            # lb_grid multichain's (mt): n = 100,000 from seed 0
            for algo in ("MH", "MP", "PMP"):
                print(f"convergence {algo}: "
                      f"{out[f'{algo}_us_per_iter']:.3f} us per iteration "
                      f"({smi})")
                tail_check(f"convergence {algo}",
                           (out[f"{algo}_beta0"], out[f"{algo}_beta1"]), et,
                           bench)
            conv_saved = load_trace(f"{tmp}/convergence/convergence.npz")

            out, counts = drive("lb_grid", lb_grid, n_data=100_000,
                                num_steps=LB_STEPS, method="sweep")
            require(counts == {"linreg_rss": 4 * 3 * LB_STEPS},
                    f"lb_grid: one linreg_rss launch a superstep: {counts}")
            for key, v in out.items():
                tail_check(f"lb_grid {key}", (v,), mt, bench)

            out, _ = drive("correlation", correlation, scale="paper")
            # the deepest cells again at seeds 1.. (no kernel runs here)
            deep = [out] + [
                correlation.run(out_dir=f"{tmp}/correlation_s{s}",
                                device=dev, scale="paper", Ns=(31,),
                                nums=(250,), seed=s)
                for s in range(1, CORR_SEEDS)]
            for dim, ref in CORR_PMPX.items():
                got = np.array([o[f"d{dim}_D5_mean"] for o in deep])
                mean, sd = got.mean(), got.std(ddof=1)
                limit = CORR_Z * sd * math.sqrt(1 + 1 / CORR_SEEDS)
                print(json.dumps({
                    "correlation": f"d={dim} depth 5, chain_len 250",
                    "pooled_mean_by_seed": got.tolist(),
                    "seeds_mean": mean, "seeds_sd": sd, "pmpx": ref,
                    "bound": limit}))
                require(bool(np.isfinite(got).all())
                        and abs(ref - mean) <= limit,
                        f"correlation d={dim}: pmpx's {ref} within "
                        f"{limit:.4g} of the port's seeds' mean {mean:.6g}")

            out, _ = drive("error_boxplot", error_boxplot,
                           number_sample=ERR_SAMPLES)
            require(all(math.isfinite(v) for v in out.values()),
                    "error_boxplot: finite errors")
            out, _ = drive("banana", banana, num_steps=BANANA_STEPS)
            require(abs(out["PMP_x2_mean"] + 8) < 4.0,
                    "banana: PMP's x2 mean within pmpx's bound")

            # skewness: 64 chains of binary P = 8 in one batch, one
            # linreg_rss launch of their 512 states a superstep
            out, counts = drive("skewness", skewness, scale="paper",
                                method="sweep", num_steps=SKEW_STEPS,
                                checkpoints=SKEW_MARKS)
            require(counts == {"linreg_rss": SKEW_STEPS,
                               **tree_launches(SKEW_STEPS)},
                    f"skewness: one linreg_rss launch (and one of each tree "
                    f"kernel) a batched superstep for all 64 chains: "
                    f"{counts}")
            require(all(math.isfinite(v) for v in out.values()),
                    "skewness: finite")

            # multichain: the fused farm sweep at pmpx's 5000 steps, and
            # one chain-batched run
            out, counts = drive("multichain_sweep", multichain, mode="sweep",
                                path="fused", n_data=MC_N,
                                num_steps=MC_STEPS)
            rows = out["rows"]
            print(json.dumps({"multichain_sweep": [
                {k: r[k] for k in ("algo", "P", "wall_s", "rhat_beta0",
                                   "rhat_beta1", "rhat_sigma",
                                   "agg_ess_per_s")} for r in rows],
                "device": name, "power": smi}))
            require(len(rows) == 14, "multichain: 14 cells")
            require(counts == {fc.FARM_KERNEL: 14 * 2 * MC_STEPS // 500},
                    f"multichain: one farm launch a 500-step chunk: {counts}")
            for r in rows:
                worst = max(r[f"rhat_{k}"] for k in ("beta0", "beta1",
                                                     "sigma"))
                require(worst <= MC_RHAT_MAX,
                        f"multichain {r['algo']} P={r['P']}: split-R-hat "
                        f"{worst} <= {MC_RHAT_MAX}")
            out, counts = drive("multichain_run", multichain, scale="paper",
                                method="sweep")
            require(counts == {"linreg_rss": 5000, **tree_launches(5000)},
                    f"multichain run: one launch of each a batched "
                    f"superstep: {counts}")
            require(out["rhat_beta0"] < 1.2
                    and abs(out["mean_beta0"] + 1.0) < 0.15,
                    "multichain run: R-hat and mean of beta0")

            # the native runtime: built here, a trace written and read back
            require(runtime.native_available(), "the native runtime built")
            rows_t = np.concatenate(
                [conv_saved["PMP_params"], conv_saved["PMP_time"][:, None]],
                axis=1).astype(np.float32)
            w = runtime.TraceWriter(f"{tmp}/conv_pmp.pmpx", rows_t.shape[1])
            for r in rows_t:
                w.append(r)
            require(w.close() == len(rows_t), "TraceWriter wrote every row")
            back = runtime.read_trace(f"{tmp}/conv_pmp.pmpx")
            require(np.array_equal(back, rows_t),
                    "the trace read back bit-equal")
            print(f"runtime: {runtime.library_path().name}, a "
                  f"{rows_t.shape} trace read back bit-equal")
        print(json.dumps({
            "phase11_reduced": [
                f"lb_grid num_steps {LB_STEPS} (the paper's 2500)",
                f"error_boxplot number_sample {ERR_SAMPLES} (the paper's "
                "1000)",
                f"banana num_steps {BANANA_STEPS} (the paper's 50,000)",
                f"skewness num_steps {SKEW_STEPS} with checkpoints "
                f"{list(SKEW_MARKS)} (the paper's 100,000 and 5,000, "
                "20,000, 50,000, 100,000)",
            ], "n_data": 100_000, "launches": p11}))
        for k in kernels:
            if k["name"] in ("linreg_rss", fc.FARM_KERNEL):
                k["launches"] += p11.get(k["name"], 0)

    with Phase("12 checkpoint/resume and the HMC samplers"):
        p12 = phase12(dev, name, smi, bench)
        for k in kernels:
            if k["name"] in p12:
                k["launches"] += p12[k["name"]]

    with Phase("13 the MNIST CNN, the packed layouts, nn_perf, doctor"):
        p13 = phase13(dev, name, smi)
        for k in kernels:
            if k["name"] in p13:
                k["launches"] += p13[k["name"]]

    with Phase("14 the mesh: chains, data and tree axes"):
        p14 = phase14(dev, name, smi, bench)
        for k in kernels:
            if k["name"] in p14:
                k["launches"] += p14[k["name"]]

    with Phase("15 the data-sharded NN posterior and sync-BN"):
        p15 = phase15(dev, name, smi)
        for k in kernels:
            if k["name"] in p15:
                k["launches"] += p15[k["name"]]

    with Phase("16 the compiled chain"):
        p16 = phase16(dev, name, smi, bench)
        for k in kernels:
            if k["name"] in p16:
                k["launches"] += p16[k["name"]]

    with Phase("17 the examples, the zoo, the paper queue, the profile"):
        p17 = phase17(dev, name, smi)
        for k in kernels:
            if k["name"] in p17:
                k["launches"] += p17[k["name"]]

    print(json.dumps({
        "bench": "pmp_p1024_n100k", "device": name, "power": smi,
        "total_wall_s": time.perf_counter() - t_start,
    }))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
