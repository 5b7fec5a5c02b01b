"""The HMC family of pmpx_torch (SP-, MP- and PMP-HMC) against pmpx's on
the same NumPy inputs and replayed noise, and the properties pmpx's own
tests hold (tests/test_hmc.py, test_hmc_rng.py, test_pmp_hmc_general.py)
under the port's generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.samplers import hmc as jhmc  # noqa: E402
from pmpx.targets import Gaussian1D as JGauss  # noqa: E402
from pmpx.targets import StandardMVN as JMVN  # noqa: E402
from pmpx.targets.linreg import BayesLinReg as JLinReg  # noqa: E402
from pmpx.targets.linreg import make_synthetic_linreg  # noqa: E402
from pmpx_torch.config import SamplerSpec  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.samplers import hmc as thmc  # noqa: E402
from pmpx_torch.samplers.base import run_chain  # noqa: E402
from pmpx_torch.targets import Gaussian1D, StandardMVN  # noqa: E402

# log_accept of the two packages on the same replayed noise
RTOL = 1e-5
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _targets(name):
    """(pmpx target, port target, start state, step, mom_scale)."""
    if name == "gauss":
        return JGauss(), Gaussian1D(), np.array([0.7], np.float32), 0.4, 1.0
    if name == "mvn":
        return (JMVN(d=3), StandardMVN(d=3),
                np.array([0.5, -1.0, 0.2], np.float32), 0.3, 1.0)
    x, y = make_synthetic_linreg(jax.random.key(0), 2048)
    # the same evaluation on both sides (tests/test_torch_linreg.py holds
    # the f32 sums of the sweep to pmpx's)
    jt = JLinReg(x, y, temper=0.02, method="suffstats")
    tt = linreg_from_numpy(np.asarray(x), np.asarray(y), temper=0.02,
                           method="suffstats", device="cpu")
    return jt, tt, np.array([-0.9, 1.9, 0.6], np.float32), 0.05, 1.0


def _single_u(log_accept, root):
    """pmpx draws a single index by Gumbel-max: the inverse-CDF uniform
    that lands on the same index."""
    p = np.asarray(jax.nn.softmax(jnp.asarray(log_accept)), np.float64)
    cdf = np.cumsum(p) / p.sum()
    lo = cdf[root - 1] if root else 0.0
    return torch.tensor([(lo + cdf[root]) / 2.0], dtype=torch.float32)


TARGETS = ["gauss", "mvn", "linreg"]


@pytest.mark.parametrize("name", TARGETS)
@pytest.mark.parametrize("num_leapfrog,accept_scale", [(1, 1.0), (3, 1.0),
                                                       (1, 1000.0)])
def test_sp_hmc_matches_pmpx(name, num_leapfrog, accept_scale):
    jt, tt, theta, step, ms = _targets(name)
    if accept_scale > 1:
        step, ms = step * 0.01, ms * 0.01  # the reference's SP-HMC scales
    kw = dict(step_size=step, mom_scale=ms, num_leapfrog=num_leapfrog,
              accept_scale=accept_scale)
    key = jax.random.key(3)
    th2, out = jhmc.make_superstep(jt, jhmc.HMCConfig(**kw))(
        key, jnp.asarray(theta))
    k_p, k_acc, _ = jax.random.split(key, 3)
    mom = ms * jax.random.normal(k_p, theta.shape, jnp.float32)
    u = jax.random.uniform(k_acc, (), jnp.float32)
    tth2, tout = thmc.make_superstep(tt, thmc.HMCConfig(**kw))(
        None, _t(theta), mom=_t(mom), u=_t(u))
    np.testing.assert_allclose(float(tout["log_accept"]),
                               float(out["log_accept"]), rtol=RTOL, atol=ATOL)
    assert bool(tout["accepted"]) == bool(out["accepted"])
    np.testing.assert_allclose(tth2.numpy(), np.asarray(th2), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", TARGETS)
@pytest.mark.parametrize("N", [1, 2, 4])
def test_mp_hmc_matches_pmpx(name, N):
    jt, tt, theta, step, ms = _targets(name)
    kw = dict(N=N, step_size=step, mom_scale=ms)
    key = jax.random.key(10 + N)
    th2, out = jhmc.make_superstep(jt, jhmc.MPHMCConfig(**kw))(
        key, jnp.asarray(theta))
    k_p, k_rev, _, _ = jax.random.split(key, 4)
    mom = ms * jax.random.normal(k_p, theta.shape, jnp.float32)
    ranint = jax.random.randint(k_rev, (), 1, N + 1)
    root = int(out["root_index"])
    tth2, tout = thmc.make_superstep(tt, thmc.MPHMCConfig(**kw))(
        None, _t(theta), mom=_t(mom), ranint=_t(ranint),
        u=_single_u(out["log_accept"], root))
    got, want = tout["log_accept"].numpy(), np.asarray(out["log_accept"])
    if name == "linreg":
        # A_j = exp(min(0, H_j - H_0)) and A_0 = N - sum_j A_j cancel in
        # f32: past the reversal point the trajectory walks back to theta,
        # so H_j - H_0 is a few ulp of |H| (~34 here), where the two
        # packages' f32 sums round differently.  The log weights are then
        # ill-conditioned; the resampling law A / N is not: it agrees to 4
        # ulp of |H_0| a weight.
        h0 = abs(float(jt.log_prob(jnp.asarray(theta)))) + 0.5 * float(
            jnp.sum(mom * mom))
        tol = 4 * N * float(np.spacing(np.float32(h0)))
        np.testing.assert_allclose(np.exp(got) / N, np.exp(want) / N,
                                   rtol=0, atol=tol)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert int(tout["root_index"]) == root
    np.testing.assert_allclose(tth2.numpy(), np.asarray(th2), rtol=1e-6,
                               atol=1e-6)


def _pmp_replay(jt, tt, theta, cfg_kw, key):
    """One superstep of each package, the port's on pmpx's momenta,
    uniforms and pick."""
    jcfg = jhmc.PMPHMCConfig(**cfg_kw)
    th2, out = jhmc.make_superstep(jt, jcfg)(key, jnp.asarray(theta))
    k_mom, k_draw, k_root, _ = jax.random.split(key, 4)
    base, D, d = jcfg.N + 1, jcfg.depth, theta.shape[0]
    mom = np.zeros((jcfg.P, d), np.float32)
    for i, k in enumerate(jax.random.split(k_mom, D)):
        temp = base**i
        mom[temp:base * temp] = jcfg.mom_scale * np.asarray(
            jax.random.normal(k, (jcfg.N * temp, d), jnp.float32))
    if jcfg.selection == "single":
        u = _single_u(out["log_accept"], int(out["root_index"]))
        pick = None
    else:
        u = _t(jax.random.uniform(k_draw, (jcfg.P,), jnp.float32))
        pick = _t(jax.random.randint(k_root, (), 0, jcfg.P))
    tth2, tout = thmc.make_superstep(tt, thmc.PMPHMCConfig(**cfg_kw))(
        None, _t(theta), mom=_t(mom), u=u, pick=pick)
    return (th2, out), (tth2, tout)


@pytest.mark.parametrize("name", TARGETS)
@pytest.mark.parametrize("N,depth", [(1, 1), (1, 2), (1, 3), (2, 1), (2, 2),
                                     (2, 3)])
@pytest.mark.parametrize("rule", ["barker", "mh_clamp", "barker_clamp"])
def test_pmp_hmc_matches_pmpx(name, N, depth, rule):
    jt, tt, theta, step, ms = _targets(name)
    kw = dict(N=N, depth=depth, step_size=step, mom_scale=ms, rule=rule)
    (th2, out), (tth2, tout) = _pmp_replay(
        jt, tt, theta, kw, jax.random.key(100 * N + depth))
    np.testing.assert_allclose(tout["log_accept"].numpy(),
                               np.asarray(out["log_accept"]), rtol=RTOL,
                               atol=ATOL)
    assert int(tout["root_index"]) == int(out["root_index"])
    np.testing.assert_allclose(tth2.numpy(), np.asarray(th2), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("selection", ["all_first", "all_uniform"])
def test_pmp_hmc_emits_every_draw_like_pmpx(selection):
    jt, tt, theta, step, ms = _targets("linreg")
    kw = dict(N=1, depth=3, step_size=step, mom_scale=ms,
              selection=selection)
    (th2, out), (tth2, tout) = _pmp_replay(jt, tt, theta, kw,
                                           jax.random.key(5))
    assert tout["samples"].shape == (8, 3)
    assert int(tout["root_index"]) == int(out["root_index"])
    np.testing.assert_allclose(tout["samples"].numpy(),
                               np.asarray(out["samples"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tth2.numpy(), np.asarray(th2), rtol=1e-6,
                               atol=1e-6)


def test_config_validation_matches_pmpx():
    for kw in (dict(rule="nope"), dict(selection="nope"), dict(N=0),
               dict(depth=0)):
        args = dict(depth=2, step_size=0.1) | kw
        with pytest.raises(ValueError):
            jhmc.PMPHMCConfig(**args)
        with pytest.raises(ValueError):
            thmc.PMPHMCConfig(**args)
    assert thmc.PMPHMCConfig(depth=3, N=2, step_size=0.1).P == 27
    with pytest.raises(TypeError):
        thmc.make_superstep(StandardMVN(d=2), object())


# ---------------------------------------------------------------------------
# pmpx's own HMC properties, on the port
# ---------------------------------------------------------------------------


def test_leapfrog_energy_conservation():
    """Small-step leapfrog on an isotropic Gaussian conserves H to
    O(eps^2) (tests/test_hmc.py)."""
    vg = thmc._value_and_grad_batch(StandardMVN(d=4))
    theta = torch.tensor([[1.0, -0.5, 0.3, 2.0]])
    p = torch.tensor([[0.4, 0.1, -0.7, 0.2]])
    lp0, _ = vg(theta, None)
    h0 = lp0[0] - 0.5 * torch.sum(p * p)
    th, pp = theta, p
    for _ in range(100):
        th, pp, lp, _ = thmc._leapfrog(vg, th, pp, 0.01, None)
    h1 = lp[0] - 0.5 * torch.sum(pp * pp)
    assert abs(float(h1 - h0)) < 1e-3


def test_leapfrog_reversibility():
    vg = thmc._value_and_grad_batch(StandardMVN(d=3))
    theta = torch.tensor([[0.5, -1.0, 0.2]])
    p = torch.tensor([[0.3, 0.6, -0.1]])
    th, pp, _, _ = thmc._leapfrog(vg, theta, p, 0.1, None)
    back, pb, _, _ = thmc._leapfrog(vg, th, -pp, 0.1, None)
    torch.testing.assert_close(back, theta, atol=1e-5, rtol=0)
    torch.testing.assert_close(-pb, p, atol=1e-5, rtol=0)


def _samples(target, spec, steps, seed, burn=0.3):
    sup = spec.build(target)
    g = torch.Generator()
    g.manual_seed(seed)
    with torch.no_grad():
        _, recs = run_chain(sup, g, torch.zeros(target.d), steps)
    s = recs["samples"].reshape(-1, target.d).numpy()
    return s[int(burn * len(s)):]


def test_sp_hmc_gaussian_moments():
    s = _samples(Gaussian1D(), SamplerSpec(
        algo="sp_hmc", step_size=0.5, num_leapfrog=3), 2000, 0)
    assert abs(s.mean()) < 0.1
    assert abs(s.std() - 1.0) < 0.1


def test_pmp_hmc_depth1_barker_exact():
    """Depth-1 PMP-HMC with the Barker rule is Barker-accept HMC: exact."""
    s = _samples(Gaussian1D(), SamplerSpec(
        algo="pmp_hmc", depth=1, step_size=0.5, rule="barker"), 4000, 1)
    assert abs(s.mean()) < 0.1
    assert abs(s.std() - 1.0) < 0.1


@pytest.mark.parametrize("rule", ["barker", "mh_clamp", "barker_clamp"])
def test_pmp_hmc_tree_runs_all_rules(rule):
    s = _samples(StandardMVN(d=2), SamplerSpec(
        algo="pmp_hmc", depth=3, step_size=0.4, rule=rule), 1500, 2)
    assert np.isfinite(s).all()
    # the clamped reference rules are heuristics: loose bounds, as pmpx's
    assert abs(s.mean()) < 0.35
    assert 0.5 < s.std() < 1.5


def test_mp_hmc_trajectory_moments():
    s = _samples(Gaussian1D(), SamplerSpec(
        algo="mp_hmc", N=4, step_size=0.3), 1200, 3)
    assert np.isfinite(s).all()
    assert abs(s.mean()) < 0.25
    assert 0.7 < s.std() < 1.3


def test_pmp_hmc_general_tree_stationary():
    """Chains started at the target stay at it (test_pmp_hmc_general.py's
    one-superstep exactness) for an N = 3 tree under the Barker rule: a
    batch of independent starts from N(0, 1), one superstep each."""
    from scipy import stats

    sup = thmc.make_superstep(Gaussian1D(), thmc.PMPHMCConfig(
        N=3, depth=2, step_size=0.6, rule="barker"))
    g = torch.Generator()
    g.manual_seed(7)
    starts = torch.randn(1500, 1, generator=g)
    with torch.no_grad():
        ends = torch.stack([sup(g, s)[0] for s in starts])
    assert stats.kstest(ends[:, 0].numpy(), "norm").pvalue > 1e-3


# ---------------------------------------------------------------------------
# the generator: a separate draw for each density evaluation
# ---------------------------------------------------------------------------


class _StochasticQuadratic:
    """A needs_rng target whose density is exact and whose every
    evaluation records the draw it took from the generator."""

    d = 2
    needs_rng = True

    def __init__(self, fused: bool):
        self.draws = []
        if fused:
            self.value_and_grad_batch = self._vgb

    def _noise(self, generator):
        z = torch.rand((), generator=generator)
        self.draws.append(float(z))
        return 0.0 * z

    def log_prob(self, theta, generator=None):
        return -0.5 * torch.sum(theta * theta) + self._noise(generator)

    def _vgb(self, Theta, generator=None):
        z = self._noise(generator)
        return -0.5 * torch.sum(Theta * Theta, dim=-1) + z, -Theta


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("cfg", [
    thmc.HMCConfig(step_size=0.1, num_leapfrog=3),
    thmc.MPHMCConfig(N=4, step_size=0.1),
    thmc.PMPHMCConfig(depth=3, step_size=0.1),
], ids=["sp", "mp", "pmp"])
def test_distinct_draw_per_density_eval(cfg, fused):
    target = _StochasticQuadratic(fused)
    g = torch.Generator()
    g.manual_seed(7)
    thmc.make_superstep(target, cfg)(g, torch.tensor([0.3, -0.4]))
    seen = target.draws
    assert len(seen) >= 3
    assert len(set(seen)) == len(seen), (
        f"{len(seen) - len(set(seen))} repeated draws of {len(seen)}")


@pytest.mark.parametrize("algo", ["sp_hmc", "mp_hmc", "pmp_hmc"])
def test_superstep_reads_nothing_back_to_the_host(algo):
    """No .item() and no branch on device data inside a superstep, over
    the linreg posterior on the sweep (linreg_rss's plain version here)."""
    from torch.profiler import ProfilerActivity, profile

    x, y = make_synthetic_linreg(jax.random.key(1), 1000)
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=0.05,
                           method="sweep", device="cpu")
    sup = SamplerSpec(algo=algo, N=3, depth=2, step_size=0.002).build(tt)
    g = torch.Generator()
    g.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_chain(sup, g, torch.tensor([-1.0, 2.0, 0.5]), 3)
    names = {e.key for e in prof.key_averages()}
    assert "aten::_local_scalar_dense" not in names
    assert "aten::item" not in names
