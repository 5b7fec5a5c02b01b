"""The linreg likelihood of pmpx_torch against pmpx: the sweep's plain
version, every evaluation method, the closed-form gradient, and the
wrapper's input checks.

Tolerances.  pmpx's f32 sweep (``batched_rss_xla`` and the Pallas kernel in
interpret mode, which agree bit for bit) sits about 1.2e-5 (relative) off
the float64 value of the same padded sums on the CPU; the port's plain
version sits within 1e-6 of it.  The raw sums are therefore held to the
float64 value at rtol 1e-6 and to pmpx at rtol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.kernels import linreg as jk  # noqa: E402
from pmpx.targets import linreg as jlin  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.kernels import linreg as tk  # noqa: E402
from pmpx_torch.targets import linreg as tlin  # noqa: E402


def _np(a):
    return np.array(a)


def _data(n, seed):
    x, y = jlin.make_synthetic_linreg(jax.random.key(seed), n)
    return _np(x), _np(y)


@pytest.mark.parametrize("n,P,seed", [(3000, 32, 2), (5000, 200, 3),
                                      (2048, 8, 0), (20000, 64, 5)])
def test_batched_rss_ref_matches_pmpx(n, P, seed):
    x, y = _data(n, seed)
    x2d, y2d = jlin.pad_to_grid(jnp.asarray(x)), jlin.pad_to_grid(
        jnp.asarray(y))
    b0 = jax.random.normal(jax.random.key(seed + 10), (P,))
    b1 = jax.random.normal(jax.random.key(seed + 20), (P,))
    jb0, jb1, jP = jk.pad_proposals(b0, b1)
    tb0, tb1, tP = tk.pad_proposals(torch.tensor(_np(b0)),
                                    torch.tensor(_np(b1)))
    assert tP == jP == P
    np.testing.assert_array_equal(tb0.numpy(), _np(jb0))
    tx2d = tlin.pad_to_grid(torch.tensor(x))
    ty2d = tlin.pad_to_grid(torch.tensor(y))
    np.testing.assert_array_equal(tx2d.numpy(), _np(x2d))

    before = launches["linreg_rss"]
    got = tk.batched_rss(tb0, tb1, tx2d, ty2d).numpy()
    assert launches["linreg_rss"] == before  # a CPU tensor: plain version
    np.testing.assert_array_equal(
        got, tk.batched_rss_ref(tb0, tb1, tx2d, ty2d).numpy())

    X, Y = _np(x2d).astype(np.float64), _np(y2d).astype(np.float64)
    B0, B1 = _np(jb0).astype(np.float64), _np(jb1).astype(np.float64)
    exact = ((Y[None] - B0[:, None, None] - B1[:, None, None] * X[None])
             ** 2).sum((1, 2))
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    xla = _np(jk.batched_rss_xla(jb0, jb1, x2d, y2d))
    pallas = _np(jk.batched_rss(jb0, jb1, x2d, y2d, interpret=True))
    np.testing.assert_allclose(got, xla, rtol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5)

    # the pad_count path: raw sweep minus the padded points' b0^2
    pad = x2d.size - n
    corrected = got[:P] - pad * tb0.numpy()[:P] ** 2
    want = ((y[None].astype(np.float64) - B0[:P, None]
             - B1[:P, None] * x[None]) ** 2).sum(1)
    np.testing.assert_allclose(corrected, want, rtol=2e-5 * x2d.size / n)


@pytest.mark.parametrize("tmethod,jmethod", [("sweep", "suffstats"),
                                             ("fused", "fused"),
                                             ("suffstats", "suffstats")])
@pytest.mark.parametrize("P", [32, 200])
def test_log_prob_batch_all_methods(tmethod, jmethod, P):
    """Every method against pmpx.  The sweep is held to pmpx's
    "suffstats" (the same function, from float64 statistics): pmpx's own
    f32 sweep ("xla") is 1.4e-4 (relative) off the float64 value here,
    its 1.2e-5 error on the raw padded sum amplified by the subtraction of
    pad_count*b0^2 (see the next test)."""
    x, y = _data(5000, 1)
    jt = jlin.BayesLinReg(jnp.asarray(x), jnp.asarray(y), temper=0.05,
                          method=jmethod)
    tt = linreg_from_numpy(x, y, temper=0.05, method=tmethod, device="cpu")
    Theta = (np.random.default_rng(P).normal(size=(P, 3)) * 0.3
             + [-1.0, 2.0, 0.5]).astype(np.float32)
    want = _np(jt.log_prob_batch(jnp.asarray(Theta)))
    got = tt.log_prob_batch(torch.tensor(Theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(float(tt.log_prob(torch.tensor(Theta[0]))),
                               want[0], rtol=1e-5)


def test_sweep_log_prob_against_pmpx_sweep_and_float64():
    """Like for like with pmpx's f32 sweep ("xla"), at the tolerance its
    own error against float64 sets (1.4e-4 relative on these inputs); the
    port's sweep against the float64 value at rtol 1e-5."""
    x, y = _data(5000, 1)
    jt = jlin.BayesLinReg(jnp.asarray(x), jnp.asarray(y), temper=0.05,
                          method="xla")
    tt = linreg_from_numpy(x, y, temper=0.05, method="sweep", device="cpu")
    Theta = (np.random.default_rng(32).normal(size=(200, 3)) * 0.3
             + [-1.0, 2.0, 0.5]).astype(np.float32)
    got = tt.log_prob_batch(torch.tensor(Theta)).numpy()
    np.testing.assert_allclose(
        got, _np(jt.log_prob_batch(jnp.asarray(Theta))), rtol=3e-4)
    X, Y, T = x.astype(np.float64), y.astype(np.float64), Theta.astype(
        np.float64)
    rss = ((Y[None] - T[:, :1] - T[:, 1:2] * X[None]) ** 2).sum(1)
    s2 = T[:, 2] ** 2
    exact = 0.05 * (-0.5 * 5000 * (np.log(2 * np.pi) + np.log(s2))
                    - rss / (2 * s2))
    np.testing.assert_allclose(got, exact, rtol=1e-5)


@pytest.mark.parametrize("n,temper", [(4000, 0.1), (20000, 1e-3)])
def test_value_and_grad_batch(n, temper):
    """Against pmpx on its float64 statistics ("suffstats" on both sides,
    so that the same f32 formula is compared; f32 sums in two orders would
    move the sigma component, which cancels -n/sigma against
    rss/sigma^3); the port's sweep against float64 autograd."""
    x, y = _data(n, 4)
    jt = jlin.BayesLinReg(jnp.asarray(x), jnp.asarray(y), temper=temper,
                          method="suffstats")
    tt = linreg_from_numpy(x, y, temper=temper, method="suffstats",
                           device="cpu")
    Theta = (np.random.default_rng(0).normal(size=(16, 3)) * 0.3
             + [-1.0, 2.0, 0.5]).astype(np.float32)
    jv, jg = jt.value_and_grad_batch(jnp.asarray(Theta))
    tv, tg = tt.value_and_grad_batch(torch.tensor(Theta))
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-5, atol=1e-3)
    # the closed form is the gradient of the values
    sv, sg = linreg_from_numpy(x, y, temper=temper, method="sweep",
                               device="cpu").value_and_grad_batch(
                                   torch.tensor(Theta))
    th = torch.tensor(Theta, dtype=torch.float64, requires_grad=True)
    t64 = tlin.BayesLinReg(torch.tensor(x, dtype=torch.float64),
                           torch.tensor(y, dtype=torch.float64),
                           temper=temper, method="suffstats", device="cpu")
    b0, b1, s = th[:, 0], th[:, 1], th[:, 2]
    xd, yd = t64.x.double(), t64.y.double()
    rss = ((yd[None] - b0[:, None] - b1[:, None] * xd[None]) ** 2).sum(1)
    ll = t64._loglik_from_rss(rss, s)
    ll.sum().backward()
    np.testing.assert_allclose(sv.numpy(), ll.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(sg.numpy(), th.grad.numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(th.grad.numpy()).max())


def test_batched_rss_checks_its_inputs():
    b = torch.zeros(64)
    g = torch.zeros(128, 128)
    with pytest.raises(TypeError):
        tk.batched_rss(b.double(), b, g, g)
    with pytest.raises(ValueError):
        tk.batched_rss(b, torch.zeros(32), g, g)  # mismatched proposals
    with pytest.raises(ValueError):
        tk.batched_rss(b, b, torch.zeros(128, 64), torch.zeros(128, 64))
    with pytest.raises(ValueError):
        tk.batched_rss(torch.zeros(100), torch.zeros(100), g, g)  # P % 64
    with pytest.raises(ValueError):
        tk.batched_rss(b, b, torch.zeros(130, 128), torch.zeros(130, 128))
    with pytest.raises(ValueError):
        tk.batched_rss(b, b, torch.zeros(128, 256)[:, ::2], g)  # strided
    with pytest.raises(ValueError):
        tk.batched_rss(b, b, g.to("meta"), g)  # another device


def test_entry_points_default_to_cuda():
    """Without a card, an entry point that was not asked for the CPU
    raises instead of carrying on there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlin.BayesLinReg(np.zeros(4), np.zeros(4))
    with pytest.raises(ValueError):
        tlin.BayesLinReg(np.zeros(4), np.zeros(4), method="cuda",
                         device="cpu")


@pytest.mark.parametrize("name", ["pallas", "xla"])
def test_pmpx_sweep_names_give_the_sweep(name):
    """pmpx's names of its two sweeps are names of the port's "sweep":
    the same method and bit-equal log-densities."""
    x, y = _data(3000, 2)
    sweep = linreg_from_numpy(x, y, temper=0.05, method="sweep",
                              device="cpu")
    alias = linreg_from_numpy(x, y, temper=0.05, method=name, device="cpu")
    assert alias.method == "sweep"
    Theta = torch.tensor((np.random.default_rng(7).normal(size=(64, 3))
                          * 0.3 + [-1.0, 2.0, 0.5]).astype(np.float32))
    assert torch.equal(alias.log_prob_batch(Theta),
                       sweep.log_prob_batch(Theta))
