"""The chain-batched superstep (a (C, d) state through the tree samplers
and MH) and ``run_chains_vmapped`` against pmpx's ``run_chains_vmapped``
on the same keys: each chain's noise is replayed from pmpx's per-chain
keys, so the batch must make pmpx's selections and reach its states.
Chain c of the batch must equal the single-chain superstep on chain c's
noise, and a superstep must evaluate the whole batch in one
``batch_log_prob`` call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.config import SamplerSpec as JSpec  # noqa: E402
from pmpx.parallel import run_chains_vmapped as jrun  # noqa: E402
from pmpx.targets import StandardMVN as JMVN  # noqa: E402
from pmpx.targets.linreg import BayesLinReg as JLinReg  # noqa: E402
from pmpx.targets.linreg import make_synthetic_linreg  # noqa: E402
from pmpx_torch.config import SamplerSpec as TSpec  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.parallel import run_chains_vmapped as trun  # noqa: E402
from pmpx_torch.targets import StandardMVN as TMVN  # noqa: E402

C, T = 3, 8
# (sampler spec fields, P): binary PMP, a 3 x 2 tree, flat MP, MH
SAMPLERS = {
    "pmp_binary": (dict(algo="pmp", N=1, depth=3, selection="all_first"), 8),
    "pmp_3x2": (dict(algo="pmp", N=3, depth=2, selection="all_uniform"), 16),
    "mp": (dict(algo="mp", N=7, selection="all_uniform"), 8),
    "mh": (dict(algo="mh"), 2),
}
STEP = 0.05
# selections equal; states and emitted samples within 1e-5 (the same f32
# additions on both sides); log weights and the chosen log-density within
# rtol 1e-5 (pmpx's float64 sufficient statistics against the port's f32
# sweep, each within ~5e-7 of float64 relative to the log-densities), log
# weights also within atol 1e-4 where they are near 0
STATE_ATOL, LOGA_ATOL, LOGP_RTOL = 1e-5, 1e-4, 1e-5


class _Counting:
    """A target that records the rows of every batched evaluation."""

    def __init__(self, inner):
        self.inner, self.d, self.rows = inner, inner.d, []

    def log_prob(self, theta):
        return self.inner.log_prob(theta)

    def log_prob_batch(self, Theta):
        self.rows.append(Theta.shape[0])
        return self.inner.log_prob_batch(Theta)


def _targets(kind):
    """(pmpx target, port target, theta0 (C, d)) on the same data."""
    rng = np.random.default_rng(5)
    if kind == "linreg":
        x, y = make_synthetic_linreg(jax.random.key(0), 2048)
        jt = JLinReg(x, y, temper=0.02, method="suffstats")
        tt = linreg_from_numpy(np.asarray(x), np.asarray(y), temper=0.02,
                               method="sweep", device="cpu")
        theta0 = np.concatenate([rng.uniform(-1.5, 0.5, (C, 2)),
                                 rng.uniform(0.4, 1.0, (C, 1))], axis=1)
    else:
        jt, tt = JMVN(d=4), TMVN(d=4)
        theta0 = rng.normal(size=(C, 4))
    return jt, tt, theta0.astype(np.float32)


def _noise(keys, P, d, algo):
    """Each chain's per-step noise as pmpx's run_chain and superstep draw
    it from the chain's key: (eps, u, pick) for the tree samplers, (eps,
    u) for MH, each (C, T, ...)."""
    def per_step(kt):
        if algo == "mh":
            k_eps, k_acc, _ = jax.random.split(kt, 3)
            return (STEP * jax.random.normal(k_eps, (d,), jnp.float32),
                    jax.random.uniform(k_acc, (), jnp.float32))
        k_eps, k_draw, k_root, _ = jax.random.split(kt, 4)
        return (STEP * jax.random.normal(k_eps, (P, d), jnp.float32),
                jax.random.uniform(k_draw, (P,), jnp.float32),
                jax.random.randint(k_root, (), 0, P))

    def per_chain(k):
        return jax.vmap(per_step)(jax.random.split(k, T))

    return tuple(torch.from_numpy(np.array(a))
                 for a in jax.vmap(per_chain)(keys))


def _replaying(superstep, noise):
    """The superstep on the next step's injected noise at every call."""
    step = iter(range(T))

    def replay(gen, theta):
        t = next(step)
        kw = dict(zip(("eps", "u", "pick"), (a[:, t] for a in noise)))
        return superstep(gen, theta, **kw)

    return replay


@pytest.mark.parametrize("target_kind", ["linreg", "mvn"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_batched_superstep_replays_pmpx_chains(sampler, target_kind):
    fields, P = SAMPLERS[sampler]
    jt, tt, theta0 = _targets(target_kind)
    counting = _Counting(tt)
    keys = jax.random.split(jax.random.key(17), C)
    collect = lambda th, o: {"theta": th, **o}  # noqa: E731

    jsup = JSpec(step_size=STEP, **fields).build(jt)
    jfinal, jrec = jax.jit(lambda k, t: jrun(jsup, k, t, T, collect))(
        keys, jnp.asarray(theta0))
    noise = _noise(keys, P, theta0.shape[1], fields["algo"])
    tsup = TSpec(step_size=STEP, **fields).build(counting)
    tfinal, trec = trun(_replaying(tsup, noise), None,
                        torch.from_numpy(theta0), T, collect)

    # one batched evaluation a superstep: the whole batch's states
    assert counting.rows == [C * P] * T
    sel = "accepted" if fields["algo"] == "mh" else "root_index"
    np.testing.assert_array_equal(trec[sel].numpy(), np.asarray(jrec[sel]))
    assert trec["theta"].shape == (C, T, theta0.shape[1])
    for k in ("theta", "samples"):
        np.testing.assert_allclose(trec[k].numpy(), np.asarray(jrec[k]),
                                   rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal),
                               rtol=0, atol=STATE_ATOL)
    np.testing.assert_allclose(trec["log_accept"].numpy(),
                               np.asarray(jrec["log_accept"]),
                               rtol=LOGP_RTOL, atol=LOGA_ATOL)
    np.testing.assert_allclose(trec["root_logp"].numpy(),
                               np.asarray(jrec["root_logp"]),
                               rtol=LOGP_RTOL)

    # chain c of the batch is the single-chain superstep on c's noise
    for c in range(C):
        theta = torch.from_numpy(theta0[c])
        for t in range(T):
            kw = dict(zip(("eps", "u", "pick"), (a[c, t] for a in noise)))
            theta, out = tsup(None, theta, **kw)
            assert int(out[sel]) == int(trec[sel][c, t])
            np.testing.assert_allclose(theta.numpy(),
                                       trec["theta"][c, t].numpy(),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("sampler", ["pmp_binary", "mh"])
def test_batched_superstep_draws_from_one_generator(sampler):
    """Without injected noise, C chains advance from one generator: the
    batch is reproducible from its seed, its chains differ, and the
    records stack as (C, steps, ...)."""
    fields, P = SAMPLERS[sampler]
    _, tt, theta0 = _targets("mvn")
    sup = TSpec(step_size=0.5, **fields).build(tt)
    th0 = torch.from_numpy(theta0)

    def batch(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return trun(sup, g, th0, 20, collect=lambda th, o: th)

    (fa, ra), (fb, rb) = batch(3), batch(3)
    assert torch.equal(fa, fb) and torch.equal(ra, rb)
    assert ra.shape == (C, 20, 4) and torch.equal(ra[:, -1], fa)
    assert not torch.equal(ra[0], ra[1])
    assert not torch.equal(batch(4)[1], ra)
