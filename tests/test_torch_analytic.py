"""The port's analytic targets (``pmpx_torch.targets.analytic``) against
pmpx's: the same log-densities on the same NumPy points."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pmpx.targets import analytic as ja  # noqa: E402
from pmpx_torch.targets import analytic as ta  # noqa: E402

# rtol 1e-6: the same f32 formulas, a few operations each
RTOL = 1e-6

CASES = [
    ("Gaussian1D", {}, 1),
    ("Gaussian1D", {"mu": 1.5, "sigma": 0.3}, 1),
    ("StandardMVN", {"d": 2}, 2),
    ("StandardMVN", {"d": 7}, 7),
    ("Banana", {}, 2),
    ("Banana", {"a": 3.0, "b": 0.5}, 2),
]


@pytest.mark.parametrize("name,kw,d", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_log_prob_matches_pmpx(name, kw, d):
    jt = getattr(ja, name)(**kw)
    tt = getattr(ta, name)(**kw)
    assert tt.d == jt.d == d
    X = np.random.default_rng(len(name) + d).normal(
        0.0, 3.0, (64, d)).astype(np.float32)
    want = np.asarray(jt.log_prob_batch(jnp.asarray(X)))
    got = tt.log_prob_batch(torch.tensor(X))
    assert got.shape == (64,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    for row in X[:5]:
        np.testing.assert_allclose(
            float(tt.log_prob(torch.tensor(row))),
            float(jt.log_prob(jnp.asarray(row))), rtol=RTOL, atol=1e-6)


def test_analytic_from_jax():
    from pmpx_torch.interop import analytic_from_jax

    for name, kw, _ in CASES:
        t = analytic_from_jax(getattr(ja, name)(**kw))
        assert t == getattr(ta, name)(**kw)
    with pytest.raises(TypeError):
        analytic_from_jax(object())


def test_targets_fit_the_samplers():
    """The port's superstep runs over an analytic target (the batch
    protocol of pmpx_torch.samplers.base)."""
    from pmpx_torch.samplers import pmp

    cfg = pmp.PMPConfig(N=3, depth=2, step_size=0.5)
    sup = pmp.make_superstep(ta.Banana(), cfg)
    g = torch.Generator()
    g.manual_seed(0)
    theta, out = sup(g, torch.tensor([0.0, -8.0]))
    assert theta.shape == (2,) and out["samples"].shape == (cfg.P, 2)
    assert bool(torch.isfinite(out["log_accept"]).all())
