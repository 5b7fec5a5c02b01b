"""The frozen Geyer ESS and the moment check against closed forms of an
AR(1) chain, x_t = phi x_{t-1} + sqrt(1 - phi^2) e_t: ESS / n = (1 - phi)
/ (1 + phi), mean 0, variance 1."""

import pytest
import torch

from benchmark.reference.checks import chain_ess, moment_z
from benchmark.reference.ess import ess_columns


def _ar1(phi, n, k, seed):
    g = torch.Generator().manual_seed(seed)
    e = torch.randn((n, k), generator=g, dtype=torch.float64)
    x = torch.empty_like(e)
    x[0] = e[0]
    s = (1 - phi * phi) ** 0.5
    for t in range(1, n):
        x[t] = phi * x[t - 1] + s * e[t]
    return x


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_ess_matches_ar1(phi):
    x = _ar1(phi, 100_000, 3, 1)
    ess = ess_columns(x) / x.shape[0]
    want = (1 - phi) / (1 + phi)
    assert torch.allclose(ess, torch.full_like(ess, want), rtol=0.08)


def test_flat_column_has_no_ess():
    x = torch.zeros((100, 2), dtype=torch.float64)
    x[:, 1] = torch.arange(100.0) % 3
    ess = ess_columns(x)
    assert torch.isnan(ess[0]) and torch.isfinite(ess[1])


def test_grouping_does_not_change_ess():
    x = _ar1(0.7, 5000, 6, 2)
    assert torch.allclose(ess_columns(x), ess_columns(x, max_bytes=1),
                          rtol=1e-12)


def test_moment_z_of_a_sound_chain_is_small_and_of_a_biased_one_large():
    x = _ar1(0.8, 40_000, 3, 3)
    draws = x.reshape(4, 10_000, 3)
    mean, var = torch.zeros(3, dtype=torch.float64), torch.ones(3)
    assert moment_z(draws, mean, var)["value"] < 5
    assert moment_z(draws + 0.2, mean, var)["value"] > 10
    assert moment_z(draws * 1.2, mean, var)["value"] > 10
    stuck = torch.zeros_like(draws)
    assert moment_z(stuck, mean, var)["value"] == float("inf")


def test_chain_ess_shape():
    x = _ar1(0.5, 2000, 6, 4).T.reshape(2, 3, 2000).transpose(1, 2)
    assert chain_ess(x).shape == (2, 3)
