"""The CIFAR-10 LeNet and the Bayesian MLP posteriors of pmpx_torch against
pmpx's on the same NumPy inputs: the flat-theta layout, log-densities and
gradients, the law of the stochastic forward, the torch-checkpoint
interop with conv and BatchNorm layers, and load_cifar10."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import data as jdata  # noqa: E402
from pmpx import interop as jinterop  # noqa: E402
from pmpx.models import BayesMLP as JBayes  # noqa: E402
from pmpx.models import LeNet as JLeNet  # noqa: E402
from pmpx.targets.nn import NNPosterior as JPost  # noqa: E402
from pmpx_torch import data as tdata  # noqa: E402
from pmpx_torch import interop as tinterop  # noqa: E402
from pmpx_torch.models import BayesMLP, LeNet  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402

# values: rtol 1e-5; gradients: within 1e-4 max|g| (flax's BatchNorm and
# torch's reduce the batch statistics in different orders, ~1e-7
# relative, and the backward through BN amplifies that)
VAL_RTOL = 1e-5
GRAD_TOL = 1e-4


def _images(B, shape, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B,) + shape).astype(np.float32)
    Y = rng.integers(0, 10, B).astype(np.int32)
    return X, Y


def _lenet_pair(B=32, remat=False, temper=1.0):
    X, Y = _images(B, (32, 32, 3))
    jpost = JPost(JLeNet(), jnp.asarray(X), jnp.asarray(Y), temper=temper)
    tpost = NNPosterior(LeNet(remat=remat), X, Y, temper=temper,
                        device="cpu")
    return jpost, tpost


def _thetas(jpost, P, scale=0.05, seed=1):
    """P states near pmpx's own init (the posterior's typical region)."""
    rng = np.random.default_rng(seed)
    t0 = np.asarray(jpost.init_theta())
    return (t0 + scale * rng.standard_normal((P, t0.size))).astype(
        np.float32)


def _leaves(jpost):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jpost._unravel(jpost.init_theta()))
    return [(".".join(k.key for k in path), tuple(v.shape))
            for path, v in flat]


@pytest.mark.parametrize("model", ["lenet", "bnn"])
def test_layout_matches_pmpx_ravel_order(model):
    if model == "lenet":
        jpost, tpost = _lenet_pair(B=4)
    else:
        jpost, tpost = _bnn_pair(B=4)
    assert [(p, s) for p, s, _ in tpost.layout] == _leaves(jpost)
    assert tpost.d == jpost.d
    # a theta raveled by pmpx means the same network here, leaf by leaf
    theta = _thetas(jpost, 1)[0]
    jp = jax.tree.map(np.asarray, jpost._unravel(jnp.asarray(theta)))
    tp = tpost.unravel(torch.from_numpy(theta))
    for path, _ in _leaves(jpost):
        node = jp
        for k in path.split("."):
            node = node[k]
        np.testing.assert_array_equal(tp[path].numpy(), node)
    np.testing.assert_array_equal(
        tinterop.nn_theta_from_params(tpost, jp).numpy(), theta)


def test_lenet_init_law_matches_flax():
    """The port draws flax's initialisers (their law, not their numbers):
    lecun-normal kernels with the conv fan-in kh*kw*in, BN scale 1."""
    jpost, tpost = _lenet_pair(B=4)
    jp = jpost._unravel(jpost.init_theta())
    tp = tpost.unravel(tpost.init_theta())
    for mod, leaf in (("Conv_0", "kernel"), ("Conv_1", "kernel"),
                      ("Dense_0", "kernel")):
        want = float(jnp.std(jp[mod][leaf]))
        got = float(tp[f"{mod}.{leaf}"].std())
        assert abs(got / want - 1) < 0.15, (mod, got, want)
    assert torch.equal(tp["BatchNorm_0.scale"], torch.ones(6))
    assert torch.equal(tp["BatchNorm_1.bias"], torch.zeros(16))


@pytest.mark.parametrize("temper", [1.0, 10.0])
def test_lenet_log_prob_and_grad_match_pmpx(temper):
    """32 CIFAR-shaped images, P = 4: log-densities within rtol 1e-5,
    gradients within 1e-4 max|g|."""
    jpost, tpost = _lenet_pair(B=32, temper=temper)
    Theta = _thetas(jpost, 4)
    jv, jg = jpost.value_and_grad_batch(jnp.asarray(Theta))
    tv, tg = tpost.value_and_grad_batch(torch.from_numpy(Theta))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VAL_RTOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=GRAD_TOL * np.abs(jg).max())
    lp = tpost.log_prob_batch(torch.from_numpy(Theta))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jv), rtol=VAL_RTOL)
    np.testing.assert_allclose(
        float(tpost.log_prob(torch.from_numpy(Theta[0]))),
        float(jpost.log_prob(jnp.asarray(Theta[0]))), rtol=VAL_RTOL)
    np.testing.assert_allclose(
        float(tpost.accuracy(torch.from_numpy(Theta[1]))),
        float(jpost.accuracy(jnp.asarray(Theta[1]))), atol=1e-6)


def test_lenet_remat_is_the_plain_model():
    """remat recomputes each conv block in the backward: the same values
    and gradients, bit for bit, over the same parameter tree."""
    _, plain = _lenet_pair(B=16)
    _, remat = _lenet_pair(B=16, remat=True)
    assert plain.layout == remat.layout
    Theta = torch.from_numpy(_thetas(_lenet_pair(B=4)[0], 3))
    pv, pg = plain.value_and_grad_batch(Theta)
    rv, rg = remat.value_and_grad_batch(Theta)
    assert torch.equal(pv, rv) and torch.equal(pg, rg)


def test_lenet_bf16_matches_pmpx_loosely():
    X, Y = _images(16, (32, 32, 3))
    jpost = JPost(JLeNet(), jnp.asarray(X), jnp.asarray(Y),
                  compute_dtype=jnp.bfloat16)
    tpost = NNPosterior(LeNet(), X, Y, compute_dtype=torch.bfloat16,
                        device="cpu")
    Theta = _thetas(jpost, 2)
    want = np.asarray(jpost.log_prob_batch(jnp.asarray(Theta)))
    got = tpost.log_prob_batch(torch.from_numpy(Theta)).numpy()
    # bf16 products in two libraries (tests/test_torch_nn.py's bound)
    np.testing.assert_allclose(got, want, rtol=0.02, atol=0.05)


def test_lenet_proposal_chunk_is_the_full_vmap():
    _, tpost = _lenet_pair(B=8)
    Theta = torch.from_numpy(_thetas(_lenet_pair(B=4)[0], 4))
    full = tpost.value_and_grad_batch(Theta)
    tpost.proposal_chunk = 2
    chunked = tpost.value_and_grad_batch(Theta)
    torch.testing.assert_close(chunked[0], full[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(chunked[1], full[1], rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# BayesMLP: the stochastic posterior
# ---------------------------------------------------------------------------


def _bnn_pair(B=32, hidden=32):
    X, Y = _images(B, (28, 28), seed=3)
    jpost = JPost(JBayes(hidden=hidden), jnp.asarray(X), jnp.asarray(Y),
                  stochastic=True)
    tpost = NNPosterior(BayesMLP(hidden=hidden), X, Y, stochastic=True,
                        device="cpu")
    return jpost, tpost


def _silenced(jpost, Theta, log_sigma=-30.0):
    """Theta with every log-sigma at ``log_sigma``: the forward draws
    weights exp(-30) ~ 1e-13 from their means, so no noise shows."""
    Theta = Theta.copy()
    for i in range(len(Theta)):
        p = jpost._unravel(jnp.asarray(Theta[i]))
        p = jax.tree_util.tree_map_with_path(
            lambda path, v: (jnp.full_like(v, log_sigma)
                             if "log_sigma" in path[-1].key else v), p)
        Theta[i] = np.asarray(jpost.theta_from_params(p))
    return Theta


def test_bnn_without_noise_matches_pmpx():
    jpost, tpost = _bnn_pair()
    assert tpost.needs_rng and tpost.stochastic
    Theta = _silenced(jpost, _thetas(jpost, 4, scale=0.02))
    jv, jg = jpost.value_and_grad_batch(jnp.asarray(Theta),
                                        key=jax.random.key(0))
    g = torch.Generator().manual_seed(0)
    tv, tg = tpost.value_and_grad_batch(torch.from_numpy(Theta),
                                        generator=g)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VAL_RTOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=GRAD_TOL * np.abs(jg).max())
    lp = tpost.log_prob_batch(torch.from_numpy(Theta), generator=g)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jv), rtol=VAL_RTOL)


def test_bnn_logits_law_matches_pmpx():
    """With noise, the logits' mean and variance over K forward passes
    agree (each within 5 standard errors of the difference)."""
    jpost, tpost = _bnn_pair(B=4, hidden=16)
    theta = _thetas(jpost, 1, scale=0.02)[0]
    K = 4000
    keys = jax.random.split(jax.random.key(11), K)
    jl = np.asarray(jax.vmap(lambda k: jpost._logits(
        jnp.asarray(theta), jpost.X, k))(keys))
    g = torch.Generator().manual_seed(11)
    noise = tpost._noise(g, (K,))
    tl = torch.func.vmap(lambda n: tpost._logits(
        torch.from_numpy(theta), tpost.X, n))(noise).numpy()
    assert jl.shape == tl.shape == (K, 4, 10)
    se_mean = np.sqrt((jl.var(0) + tl.var(0)) / K)
    assert np.all(np.abs(jl.mean(0) - tl.mean(0)) < 5 * se_mean + 1e-6)
    # the variance's standard error ~ var * sqrt(2 / K) for near-normal
    # logits
    v_j, v_t = jl.var(0), tl.var(0)
    se_var = np.sqrt(2.0 / K) * np.sqrt(v_j**2 + v_t**2)
    assert np.all(np.abs(v_j - v_t) < 5 * se_var + 1e-9)


def test_bnn_draws_one_noise_per_evaluation():
    _, tpost = _bnn_pair(B=8)
    theta = tpost.init_theta()
    Theta = theta.repeat(3, 1)
    g = torch.Generator().manual_seed(4)
    a = tpost.log_prob_batch(Theta, generator=g)
    b = tpost.log_prob_batch(Theta, generator=g)
    assert len(set(a.tolist())) == 3  # one draw a row
    assert not torch.equal(a, b)  # the generator moved on
    g2 = torch.Generator().manual_seed(4)
    assert torch.equal(tpost.log_prob_batch(Theta, generator=g2), a)
    v, _ = tpost.value_and_grad_batch(Theta, generator=g2)
    assert torch.equal(v, b)  # the same draws in the same order
    acc = tpost.accuracy(theta, generator=g2)
    assert 0.0 <= float(acc) <= 1.0


def test_bnn_init_law_matches_flax():
    jpost, tpost = _bnn_pair(B=4, hidden=64)
    jp = jpost._unravel(jpost.init_theta())
    tp = tpost.unravel(tpost.init_theta())
    want = float(jnp.abs(jp["BayesLinear_0"]["w_mu"]).max())
    got = float(tp["BayesLinear_0.w_mu"].abs().max())
    assert abs(got / want - 1) < 0.02  # the uniform's limit sqrt(6/784)
    np.testing.assert_allclose(
        tp["BayesLinear_1.w_log_sigma"].numpy(),
        np.asarray(jp["BayesLinear_1"]["w_log_sigma"]), rtol=1e-7)
    assert torch.equal(tp["BayesLinear_0.b_mu"], torch.zeros(64))


# ---------------------------------------------------------------------------
# interop and data
# ---------------------------------------------------------------------------


class _TorchLeNet(torch.nn.Module):
    """The reference's LeNet layer order (cifar_PMPhmc.py:33-55)."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 6, 5)
        self.bn1 = torch.nn.BatchNorm2d(6)
        self.conv2 = torch.nn.Conv2d(6, 16, 5)
        self.bn2 = torch.nn.BatchNorm2d(16)
        self.fc1 = torch.nn.Linear(400, 120)
        self.fc2 = torch.nn.Linear(120, 84)
        self.fc3 = torch.nn.Linear(84, 10)

    def forward(self, x):  # NCHW
        f = torch.nn.functional
        x = f.max_pool2d(f.relu(self.bn1(self.conv1(x))), 2)
        x = f.max_pool2d(f.relu(self.bn2(self.conv2(x))), 2)
        x = x.flatten(1)  # NCHW order
        return self.fc3(f.relu(self.fc2(f.relu(self.fc1(x)))))


def test_lenet_torch_state_maps_like_pmpx(tmp_path):
    torch.manual_seed(0)
    net = _TorchLeNet()
    with torch.no_grad():
        net.bn1.weight.uniform_(0.5, 1.5)
        net.bn2.bias.uniform_(-0.2, 0.2)
    path = tmp_path / "cifar.pkl"
    torch.save(net.state_dict(), path)
    jpost, tpost = _lenet_pair(B=8)
    want = np.asarray(jinterop.theta_from_torch_state(
        jpost, jinterop.load_torch_pickle(str(path))))
    got = tinterop.theta_from_torch_state(
        tpost, tinterop.load_torch_pickle(str(path)))
    np.testing.assert_array_equal(got.numpy(), want)
    # and the mapped network computes the torch module's logits (its BN
    # in training mode: the batch's statistics)
    X = tpost.X
    net.train()
    with torch.no_grad():
        ref = net(X.permute(0, 3, 1, 2))
        mine = tpost._logits(got, X)
    torch.testing.assert_close(mine, ref, rtol=1e-4, atol=1e-4)


def _write_cifar_batches(root, rng):
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (20, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 20))}, f)


@pytest.mark.parametrize("fmt", ["npz", "batches"])
def test_load_cifar10_reads_files_like_pmpx(tmp_path, monkeypatch, fmt):
    rng = np.random.default_rng(0)
    if fmt == "npz":
        np.savez(tmp_path / "cifar10.npz",
                 x_train=rng.integers(0, 256, (30, 32, 32, 3), np.uint8),
                 y_train=rng.integers(0, 10, 30),
                 x_test=rng.integers(0, 256, (12, 32, 32, 3), np.uint8),
                 y_test=rng.integers(0, 10, 12))
    else:
        _write_cifar_batches(tmp_path, rng)
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    want = jdata.load_cifar10(n_train=25, n_test=10)
    got = tdata.load_cifar10(n_train=25, n_test=10, device="cpu")
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert tdata.dataset_presence()[
        "cifar10_npz" if fmt == "npz" else "cifar10_batches"]


def test_load_cifar10_synthetic_stand_in(tmp_path, monkeypatch):
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    a = tdata.load_cifar10(n_train=64, n_test=16, device="cpu")
    b = tdata.load_cifar10(n_train=64, n_test=16, device="cpu")
    assert [t.shape for t in a] == [(64, 32, 32, 3), (64,), (16, 32, 32, 3),
                                    (16,)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)  # deterministic in the seed
    c = tdata.load_cifar10(n_train=64, n_test=16, device="cpu",
                           label_noise=0.5)
    assert torch.equal(c[0], a[0]) and not torch.equal(c[1], a[1])
    # pmpx's law: unit noise about class prototypes of sd class_sep
    x, y = tdata.load_cifar10(n_train=2000, n_test=4, device="cpu")[:2]
    resid = torch.cat([x[y == k] - x[y == k].mean(0) for k in range(10)])
    assert abs(float(resid.std()) - 1.0) < 0.02
    bad = tmp_path / "cifar10.npz"
    bad.write_bytes(b"not an archive")
    with pytest.raises(ValueError, match="not a readable npz"):
        tdata.load_cifar10(device="cpu")
