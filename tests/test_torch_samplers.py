"""The port's MH, MP and PSP samplers and SamplerSpec against pmpx: the
same supersteps given the same injected noise, the same configs, the same
validation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.config import SamplerSpec as JSpec  # noqa: E402
from pmpx.samplers import mp as jmp  # noqa: E402
from pmpx.samplers import psp as jpsp  # noqa: E402
from pmpx.targets.linreg import BayesLinReg as JLinReg  # noqa: E402
from pmpx.targets.linreg import make_synthetic_linreg  # noqa: E402
from pmpx_torch.config import SamplerSpec as TSpec  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.samplers import mh as tmh  # noqa: E402
from pmpx_torch.samplers import mp as tmp  # noqa: E402
from pmpx_torch.samplers import psp as tpsp  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _linreg_pair(n=1500, temper=0.05):
    x, y = make_synthetic_linreg(jax.random.key(2), n)
    # the same evaluation on both sides ("suffstats": float64 statistics),
    # so that the samplers are compared and not two f32 sums
    jt = JLinReg(x, y, temper=temper, method="suffstats")
    tt = linreg_from_numpy(np.asarray(x), np.asarray(y), temper=temper,
                           method="suffstats", device="cpu")
    return jt, tt


@pytest.mark.parametrize("proposal", ["normal", "uniform"])
@pytest.mark.parametrize("rule", ["metropolis", "barker"])
def test_mh_superstep_replays_pmpx(rule, proposal):
    """Eight supersteps from eight keys: the port, fed pmpx's eps and
    acceptance uniform, takes the same decisions and states.  log_accept
    and root_logp within rtol 1e-5 (the same f32 arithmetic, another
    order of its terms)."""
    jt, tt = _linreg_pair()
    kw = dict(step_size=0.15, rule=rule, proposal=proposal)
    jsup = JSpec(algo="mh", **kw).build(jt)
    tsup = TSpec(algo="mh", **kw).build(tt)
    theta = jnp.asarray([-0.9, 1.8, 0.55], jnp.float32)
    decisions = set()
    for s in range(8):
        key = jax.random.key(100 + s)
        th2, out = jsup(key, theta)
        k_eps, k_acc, _ = jax.random.split(key, 3)
        if proposal == "normal":
            eps = 0.15 * jax.random.normal(k_eps, (3,), jnp.float32)
        else:
            eps = jax.random.uniform(k_eps, (3,), jnp.float32, -0.15, 0.15)
        u = jax.random.uniform(k_acc, (), jnp.float32)
        tth2, tout = tsup(None, _t(theta), eps=_t(eps), u=_t(u))
        assert bool(tout["accepted"]) == bool(out["accepted"])
        decisions.add(bool(out["accepted"]))
        np.testing.assert_allclose(tth2.numpy(), np.asarray(th2), atol=1e-6)
        np.testing.assert_allclose(tout["samples"].numpy(),
                                   np.asarray(out["samples"]), atol=1e-6)
        np.testing.assert_allclose(float(tout["log_accept"]),
                                   float(out["log_accept"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(tout["root_logp"]),
                                   float(out["root_logp"]), rtol=1e-5)
        assert tout["samples"].shape == (1, 3)
        theta = th2
    assert decisions == {True, False}  # both branches were replayed


def test_mh_draws_from_the_generator():
    _, tt = _linreg_pair()
    for proposal in ("normal", "uniform"):
        sup = tmh.make_superstep(tt, tmh.MHConfig(step_size=0.1,
                                                  proposal=proposal))
        runs = []
        for _ in range(2):
            g = torch.Generator()
            g.manual_seed(4)
            runs.append(sup(g, torch.tensor([-1.0, 2.0, 0.5])))
        assert torch.equal(runs[0][0], runs[1][0])
        assert runs[0][1]["accepted"].dtype == torch.bool
    with pytest.raises(ValueError):
        tmh.MHConfig(step_size=0.1, rule="nope")
    with pytest.raises(ValueError):
        tmh.MHConfig(step_size=0.1, proposal="cauchy")


def _replay_tree(jsup, tsup, P, step, selection, key, theta):
    """One pmpx tree superstep and the port's on its (k_eps, k_draw,
    k_root) draws."""
    th2, out = jsup(key, theta)
    k_eps, k_draw, k_root, _ = jax.random.split(key, 4)
    eps = step * jax.random.normal(k_eps, (P, 3), jnp.float32)
    u = _t(jax.random.uniform(k_draw, (P,), jnp.float32))
    pick = (_t(jax.random.randint(k_root, (), 0, P))
            if selection == "all_uniform" else None)
    tth2, tout = tsup(None, _t(theta), eps=_t(eps), u=u, pick=pick)
    assert int(tout["root_index"]) == int(out["root_index"])
    # log weights of magnitude ~10, summed in another order: rtol 1e-5
    np.testing.assert_allclose(tout["log_accept"].numpy(),
                               np.asarray(out["log_accept"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tth2.numpy(), np.asarray(th2), atol=1e-6)
    np.testing.assert_allclose(tout["samples"].numpy(),
                               np.asarray(out["samples"]), atol=1e-6)
    np.testing.assert_allclose(float(tout["root_logp"]),
                               float(out["root_logp"]), rtol=1e-5)
    return th2


SPEC_CASES = [
    ("mp", dict(N=7)), ("mp", dict(N=31, trans_sigma=0.4)),
    ("psp", dict(depth=3)), ("psp", dict(depth=5)),
    ("pmp", dict(N=3, depth=2)), ("pmp", dict(N=1, depth=4)),
]


@pytest.mark.parametrize("selection", [None, "all_first", "all_uniform"])
@pytest.mark.parametrize("algo,kw", SPEC_CASES,
                         ids=[f"{a}-{i}" for i, (a, _) in
                              enumerate(SPEC_CASES)])
def test_spec_supersteps_replay_pmpx(algo, kw, selection):
    """SamplerSpec(...).build for mp, psp and pmp: three supersteps of a
    chain on pmpx's eps and uniforms give the same roots, weights and
    states (selection None is the spec's default, all_uniform)."""
    jt, tt = _linreg_pair()
    step = 0.08
    spec_kw = dict(algo=algo, step_size=step, selection=selection, **kw)
    jsup = JSpec(**spec_kw).build(jt)
    tsup = TSpec(**spec_kw).build(tt)
    if algo == "mp":
        P = kw["N"] + 1
    elif algo == "psp":
        P = 2 ** kw["depth"]
    else:
        P = (kw["N"] + 1) ** kw["depth"]
    theta = jnp.asarray([-0.7, 1.6, 0.7], jnp.float32)
    for s in range(3):
        theta = _replay_tree(jsup, tsup, P, step,
                             selection or "all_uniform",
                             jax.random.key(7 * s + P), theta)


def test_configs_map_onto_pmp_as_pmpx_maps_them():
    for jcfg, tcfg in [
        (jmp.MPConfig(N=9, step_size=0.2, trans_sigma=0.3,
                      trans_normalize_by=3.0, selection="single",
                      stabilizer="zscore", nan_guard=False),
         tmp.MPConfig(N=9, step_size=0.2, trans_sigma=0.3,
                      trans_normalize_by=3.0, selection="single",
                      stabilizer="zscore", nan_guard=False)),
        (jpsp.PSPConfig(P=64, step_size=0.1, trans_sigma=2.0,
                        selection="all_first"),
         tpsp.PSPConfig(P=64, step_size=0.1, trans_sigma=2.0,
                        selection="all_first")),
    ]:
        assert (dataclasses.asdict(tcfg.as_pmp())
                == dataclasses.asdict(jcfg.as_pmp()))
    with pytest.raises(ValueError):
        tpsp.PSPConfig(P=12, step_size=0.1).as_pmp()  # not a power of two
    with pytest.raises(ValueError):
        tmp.MPConfig(N=0, step_size=0.1).as_pmp()


# pmpx's HMC knobs, left out of the port's SamplerSpec until the HMC
# samplers that read them are ported
_HMC_FIELDS = ("mom_scale", "num_leapfrog", "accept_scale")


def test_spec_fields_defaults_and_reference_nn():
    jf = [(f.name, f.default) for f in dataclasses.fields(JSpec)
          if f.name not in _HMC_FIELDS]
    tf = [(f.name, f.default) for f in dataclasses.fields(TSpec)]
    assert tf == jf
    for name in _HMC_FIELDS:
        assert name in {f.name for f in dataclasses.fields(JSpec)}
        with pytest.raises(TypeError):
            TSpec(algo="pmp", **{name: 2})
    for algo, N in [("pmp", 7), ("psp", 1023), ("mp", 1023), ("mh", 3)]:
        j = dataclasses.asdict(JSpec.reference_nn(algo, N, step_size=0.3))
        t = TSpec.reference_nn(algo, N, step_size=0.3)
        assert dataclasses.asdict(t) == {
            k: v for k, v in j.items() if k not in _HMC_FIELDS}
    with pytest.raises(ValueError):
        TSpec.reference_nn("pmp", 6)  # 7 states is not a binary tree


def test_spec_validation_matches_pmpx():
    jt, tt = _linreg_pair(n=300)
    bad = [
        dict(algo="mp", N=3, rule="barker"),  # rule only for mh/pmp_hmc
        dict(algo="mh", rule="barker_clamp"),
        dict(algo="nope"),
        dict(algo="mp", N=3, selection="bogus"),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            JSpec(**kw).build(jt)
        with pytest.raises(ValueError):
            TSpec(**kw).build(tt)
    for algo in ("sp_hmc", "mp_hmc", "pmp_hmc"):
        JSpec(algo=algo).build(jt)  # pmpx has them
        with pytest.raises(NotImplementedError, match="item 15"):
            TSpec(algo=algo).build(tt)
