"""The MNIST CNN of pmpx_torch against pmpx's on the same NumPy inputs: the
flat-theta layout, logits, densities and gradients of ``MnistCNN``; the
space-to-depth path (``kernels/cnn_fast.py``) piece by piece, in f32 and
bf16, chunked, attached, and in a PMP chain replaying pmpx's noise; the
reference's ``CNN_model.pkl`` layout through ``theta_from_torch_state``;
and ``mnist.run(model="CNN")`` in every layout and ``cnn_kernel``
combination pmpx takes, refusing what pmpx refuses."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import interop as jinterop  # noqa: E402
from pmpx import run_chain as jrun_chain  # noqa: E402
from pmpx.experiments import mnist as jmnist  # noqa: E402
from pmpx.kernels import cnn_fast as jcf  # noqa: E402
from pmpx.models import MnistCNN as JCNN  # noqa: E402
from pmpx.samplers import pmp as jpmp  # noqa: E402
from pmpx.targets.nn import NNPosterior as JPost  # noqa: E402
from pmpx_torch import interop as tinterop  # noqa: E402
from pmpx_torch.experiments import mnist as tmnist  # noqa: E402
from pmpx_torch.kernels import cnn_fast as tcf  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.metrics.recorder import load_trace  # noqa: E402
from pmpx_torch.models import (  # noqa: E402
    LeNet, MnistCNN, MnistLSTM, MnistMLP,
)
from pmpx_torch.samplers import pmp as tpmp  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402

# logits and densities: rtol 1e-5 (two libraries' f32 convolutions and
# products); gradients within 1e-4 max|g|; the space-to-depth path against
# pmpx's: rtol and atol 2e-5 in f32, 2e-2 in bf16, the tolerances of
# pmpx's own tests/test_cnn_fast.py:36-51
VAL_RTOL = 1e-5
GRAD_TOL = 1e-4
FAST_TOL = 2e-5
BF16_TOL = 2e-2


def _data(B, seed=0, channel=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, 28, 28) + ((1,) if channel else ())).astype(
        np.float32)
    Y = rng.integers(0, 10, B).astype(np.int32)
    return X, Y


def _pair(B=24, temper=10.0, seed=0, channel=False, **kw):
    X, Y = _data(B, seed, channel)
    jkw = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}
    jpost = JPost(JCNN(), jnp.asarray(X), jnp.asarray(Y), temper=temper,
                  **jkw)
    tpost = NNPosterior(MnistCNN(), X, Y, temper=temper, device="cpu", **kw)
    tpost._theta0 = torch.tensor(np.asarray(jpost._theta0))
    return jpost, tpost


def _thetas(jpost, P, scale=0.3, seed=1):
    rng = np.random.default_rng(seed)
    t0 = np.asarray(jpost.init_theta())
    return (t0 + scale * rng.standard_normal((P, t0.size))).astype(
        np.float32)


def test_cnn_layout_matches_pmpx_ravel_order():
    jpost, tpost = _pair(B=4)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jpost._unravel(jpost.init_theta()))
    want = [(".".join(k.key for k in path), tuple(v.shape))
            for path, v in flat]
    assert [(p, s) for p, s, _ in tpost.layout] == want
    assert tpost.d == jpost.d == 1_007_590
    theta = _thetas(jpost, 1)[0]
    jp = jax.tree.map(np.asarray, jpost._unravel(jnp.asarray(theta)))
    tp = tpost.unravel(torch.from_numpy(theta))
    for path, _ in want:
        mod, leaf = path.split(".")
        np.testing.assert_array_equal(tp[path].numpy(), jp[mod][leaf])
    np.testing.assert_array_equal(
        tinterop.nn_theta_from_params(tpost, jp).numpy(), theta)


@pytest.mark.parametrize("channel", [False, True])
def test_cnn_logits_match_flax(channel):
    """(B, 28, 28) and (B, 28, 28, 1) inputs: logits within rtol 1e-5 of
    flax's MnistCNN on the same flat theta (the NHWC flatten of Dense_0's
    2000 rows included: a wrong permute changes every logit)."""
    jpost, tpost = _pair(B=16, channel=channel)
    for theta in _thetas(jpost, 2, scale=0.05):
        want = np.asarray(jpost._logits(jnp.asarray(theta), jpost.X))
        with torch.no_grad():
            got = tpost._logits(torch.from_numpy(theta), tpost.X).numpy()
        np.testing.assert_allclose(got, want, rtol=VAL_RTOL,
                                   atol=VAL_RTOL * np.abs(want).max())


def test_cnn_init_law_matches_flax():
    """flax's initialisers' law: lecun-normal with the conv fan-in."""
    jpost, tpost = _pair(B=4)
    tpost = NNPosterior(MnistCNN(), *_data(4), device="cpu")
    jp = jpost._unravel(jpost.init_theta())
    tp = tpost.unravel(tpost.init_theta())
    for mod in ("Conv_0", "Conv_1", "Dense_0", "Dense_1"):
        want = float(jnp.std(jp[mod]["kernel"]))
        got = float(tp[f"{mod}.kernel"].std())
        assert abs(got / want - 1) < 0.2, (mod, got, want)
        assert not tp[f"{mod}.bias"].any()


@pytest.mark.parametrize("temper", [1.0, 10.0])
def test_cnn_log_prob_and_grad_match_pmpx(temper):
    jpost, tpost = _pair(B=24, temper=temper)
    Theta = _thetas(jpost, 3, scale=0.05)
    jv, jg = jpost.value_and_grad_batch(jnp.asarray(Theta))
    tv, tg = tpost.value_and_grad_batch(torch.from_numpy(Theta))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VAL_RTOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=GRAD_TOL * np.abs(jg).max())
    np.testing.assert_allclose(
        float(tpost.log_prob(torch.from_numpy(Theta[0]))),
        float(jpost.log_prob(jnp.asarray(Theta[0]))), rtol=VAL_RTOL)
    np.testing.assert_allclose(
        float(tpost.accuracy(torch.from_numpy(Theta[1]))),
        float(jpost.accuracy(jnp.asarray(Theta[1]))), atol=1e-6)


# ---------------------------------------------------------------------------
# the space-to-depth path, piece by piece
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [1, 3])
def test_s2d_conv1_weights_match_pmpx(P):
    """The scatter of the 25 taps into the (3, 3, 4) kernel of each phase,
    bit for bit: 100 live slots of 144 for each proposal, 44 zero, and
    every output channel in pmpx's (proposal, phase, filter) order."""
    w = np.random.default_rng(P).standard_normal((P, 5, 5, 10)).astype(
        np.float32)
    want = np.asarray(jcf._s2d_conv1_weights(jnp.asarray(w)))
    got = tcf._s2d_conv1_weights(torch.from_numpy(w)).numpy()
    assert got.shape == (3, 3, 4, P * 40)
    np.testing.assert_array_equal(got, want)
    per = got.reshape(3, 3, 4, P, 4, 10)
    assert ((per != 0).sum(axis=(0, 1, 2)) == 25).all()  # each phase
    assert (per[..., 0] == 0).sum() == P * 4 * (36 - 25)


def test_space_to_depth_matches_pmpx():
    x = _data(5)[0]
    np.testing.assert_array_equal(
        tcf._space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jcf._space_to_depth(jnp.asarray(x))))


def test_forward_logits_match_pmpx_per_proposal():
    """The all-P logits (P, B, 10) against pmpx's, each proposal against
    the port's generic forward: a swapped phase or an interleaved conv2
    channel order would give another proposal's filters."""
    jpost, tpost = _pair(B=12)
    Theta = _thetas(jpost, 3, scale=0.1)
    jleaves = jax.vmap(jpost._unravel)(jnp.asarray(Theta))
    want = np.asarray(jcf._forward_logits(
        jleaves, jcf._space_to_depth(jpost.X), None))
    x_s2d = tcf._space_to_depth(tpost.X).permute(0, 3, 1, 2)
    got = tcf._forward_logits(tpost.unravel(torch.from_numpy(Theta)),
                              x_s2d, None).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=FAST_TOL, atol=FAST_TOL * scale)
    with torch.no_grad():
        for p in range(3):
            generic = tpost._logits(torch.from_numpy(Theta[p]),
                                    tpost.X).numpy()
            np.testing.assert_allclose(got[p], generic, rtol=FAST_TOL,
                                       atol=FAST_TOL * scale)


def test_cnn_fast_matches_pmpx_f32():
    jpost, tpost = _pair()
    Theta = _thetas(jpost, 3)
    want = np.asarray(jcf.make_fast_log_prob_batch(jpost)(
        jnp.asarray(Theta)))
    got = tcf.make_fast_log_prob_batch(tpost)(torch.from_numpy(Theta))
    np.testing.assert_allclose(got.numpy(), want, rtol=FAST_TOL,
                               atol=FAST_TOL)
    generic = tpost.log_prob_batch(torch.from_numpy(Theta))
    np.testing.assert_allclose(got.numpy(), generic.numpy(), rtol=FAST_TOL,
                               atol=FAST_TOL)


def test_cnn_fast_matches_pmpx_bf16():
    jpost, tpost = _pair(compute_dtype=torch.bfloat16)
    Theta = _thetas(jpost, 3)
    want = np.asarray(jcf.make_fast_log_prob_batch(jpost)(
        jnp.asarray(Theta)))
    got = tcf.make_fast_log_prob_batch(tpost)(torch.from_numpy(Theta))
    assert got.dtype == torch.float32
    # bf16 activations round differently per evaluation order; the CE
    # reduction is f32 on every path
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)
    generic = tpost.log_prob_batch(torch.from_numpy(Theta))
    np.testing.assert_allclose(got.numpy(), generic.numpy(), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_cnn_fast_proposal_chunk_equals_full():
    _, tpost = _pair(proposal_chunk=2)
    Theta = torch.from_numpy(_thetas(_pair(B=4)[0], 4))
    chunked = tcf.make_fast_log_prob_batch(tpost)(Theta)
    tpost.proposal_chunk = None
    full = tcf.make_fast_log_prob_batch(tpost)(Theta)
    torch.testing.assert_close(chunked, full, rtol=1e-6, atol=1e-6)
    tpost.proposal_chunk = 3
    with pytest.raises(ValueError, match="must divide"):
        tcf.make_fast_log_prob_batch(tpost)(Theta)


def test_cnn_fast_attach_routes_log_prob_and_singles():
    jpost, tpost = _pair()
    Theta = torch.from_numpy(_thetas(jpost, 2))
    tcf.attach(tpost)
    batch = tpost.log_prob_batch(Theta)
    # singles go through the same path: one evaluation order
    single = tpost.log_prob(Theta[0])
    torch.testing.assert_close(single, batch[0], rtol=1e-6, atol=1e-6)
    # the gradient keeps the generic path
    v, g = tpost.value_and_grad_batch(Theta)
    assert g.shape == Theta.shape
    torch.testing.assert_close(v, batch, rtol=FAST_TOL, atol=FAST_TOL)
    # a rebound dataset is read again
    X2, Y2 = _data(8, seed=5)
    with tpost.bound_data(torch.from_numpy(X2), torch.from_numpy(Y2).long()):
        again = tpost.log_prob_batch(Theta)
        tpost._fast_batch = None
        plain = tpost.log_prob_batch(Theta)
    torch.testing.assert_close(again, plain, rtol=FAST_TOL, atol=FAST_TOL)


@pytest.mark.parametrize("model", [MnistLSTM, MnistMLP])
def test_cnn_fast_attach_rejects_other_models(model):
    post = NNPosterior(model(), *_data(4), device="cpu")
    with pytest.raises(ValueError, match="MnistCNN"):
        tcf.attach(post)
    X = np.zeros((4, 32, 32, 3), np.float32)
    post = NNPosterior(LeNet(), X, np.zeros(4), device="cpu")
    with pytest.raises(ValueError, match="MnistCNN"):
        tcf.attach(post)


def test_pmp_chain_over_cnn_fast_replays_pmpx_noise():
    """10 PMP supersteps (binary depth 3, all_first, zscore) over the CNN
    posterior with the space-to-depth path attached on both sides, each
    superstep's eps and uniforms replayed from pmpx's key splits: the same
    roots, states within 1e-5."""
    jpost, tpost = _pair(B=32, seed=2)
    jcf.attach(jpost)
    tcf.attach(tpost)
    kw = dict(N=1, depth=3, step_size=0.02, selection="all_first",
              stabilizer="zscore")
    jcfg, tcfg = jpmp.PMPConfig(**kw), tpmp.PMPConfig(**kw)
    P, d, steps = jcfg.P, jpost.d, 10
    key = jax.random.key(7)
    theta0 = jpost._theta0
    jsup = jpmp.make_superstep(jpost, jcfg)
    _, (jstates, jroots) = jax.jit(lambda k, t: jrun_chain(
        jsup, k, t, steps, collect=lambda s, o: (s, o["root_index"])))(
            key, theta0)
    tsup = tpmp.make_superstep(tpost, tcfg)
    theta = torch.tensor(np.asarray(theta0))
    states, roots = [], []
    for k in jax.random.split(key, steps):  # run_chain's per-step keys
        k_eps, k_draw, _, _ = jax.random.split(k, 4)
        eps = jcfg.step_size * jax.random.normal(k_eps, (P, d), jnp.float32)
        u = jax.random.uniform(k_draw, (P,), jnp.float32)
        with torch.no_grad():
            theta, out = tsup(None, theta, eps=torch.tensor(np.array(eps)),
                              u=torch.tensor(np.array(u)))
        states.append(theta)
        roots.append(int(out["root_index"]))
    np.testing.assert_array_equal(roots, np.asarray(jroots))
    assert len(set(roots)) > 1  # the chain moved
    np.testing.assert_allclose(torch.stack(states).numpy(),
                               np.asarray(jstates), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's CNN_model.pkl through theta_from_torch_state
# ---------------------------------------------------------------------------


class _TorchCNN(torch.nn.Module):
    """The reference's CNN (complex_nets/Mnist/CNN/PMP_CNN.py:20-42)."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 10, 5)
        self.conv2 = torch.nn.Conv2d(10, 20, 3)
        self.fc1 = torch.nn.Linear(20 * 10 * 10, 500)
        self.fc2 = torch.nn.Linear(500, 10)

    def forward(self, x):
        x = torch.relu(self.conv1(x[:, None]))
        x = torch.nn.functional.max_pool2d(x, 2, 2)
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.fc1(x.reshape(x.shape[0], -1)))  # NCHW flatten
        return self.fc2(x)


def test_theta_from_cnn_model_pkl_matches_pmpx(tmp_path):
    """A CNN_model.pkl-shaped state dict written with torch.save maps to
    the same theta in both packages, and the port's logits on it equal the
    torch model's own: fc1's rows go from torch's NCHW flatten to flax's
    NHWC (_nchw_to_nhwc_rows)."""
    torch.manual_seed(3)
    net = _TorchCNN()
    path = tmp_path / "CNN_model.pkl"
    torch.save(net.state_dict(), path)
    jpost, tpost = _pair(B=8)
    want = np.asarray(jinterop.theta_from_torch_state(
        jpost, jinterop.load_torch_pickle(str(path))))
    got = tinterop.theta_from_torch_state(
        tpost, tinterop.load_torch_pickle(str(path)))
    np.testing.assert_array_equal(got.numpy(), want)
    with torch.no_grad():
        ref = net(tpost.X)
        logits = tpost._logits(got, tpost.X)
    torch.testing.assert_close(logits, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# mnist.run(model="CNN")
# ---------------------------------------------------------------------------


def _write_npz(path, n_train=48, n_test=16, seed=1):
    rng = np.random.default_rng(seed)
    np.savez(path / "mnist.npz",
             x_train=rng.integers(0, 256, (n_train, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, n_train).astype(np.uint8),
             x_test=rng.integers(0, 256, (n_test, 28, 28), dtype=np.uint8),
             y_test=rng.integers(0, 10, n_test).astype(np.uint8))


RUNS = [("pmp", "nhwc", False), ("pmp", "nhwc", True),
        ("mh", "packed", False), ("mp", "nhwc", True)]


@pytest.mark.parametrize("algo,layout,kernel", RUNS)
def test_mnist_cnn_run_matches_pmpx(tmp_path, monkeypatch, algo, layout,
                                    kernel):
    """mnist.run end to end on the same npz and the same CNN_model.pkl warm
    start: the same summary keys, losses within rtol 1e-3 (different noise,
    alpha = 1e-4 keeps every state near the shared start), accuracies
    within 2 of 16 test examples.  Nothing launches on the CPU."""
    _write_npz(tmp_path)
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    torch.manual_seed(4)
    ws = str(tmp_path / "CNN_model.pkl")
    torch.save(_TorchCNN().state_dict(), ws)
    kw = dict(model="CNN", algo=algo, num_steps=3, n_train=48, n_test=16,
              warm_start=ws, layout=layout, cnn_kernel=kernel)
    want = jmnist.run(out_dir=str(tmp_path / "j"), **kw)
    before = dict(launches)
    got = tmnist.run(out_dir=str(tmp_path / "t"), device="cpu", **kw)
    assert launches == before
    assert set(got) == set(want)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    for k in ("train_acc", "test_acc"):
        assert abs(got[k] - want[k]) <= 2 / 16
    stem = f"{algo.upper()}_alpha_0.0001_sample_number_3CNN_N_7"
    assert load_trace(str(tmp_path / "t" / f"{stem}.npz"))["loss"].shape == (
        3,)


@pytest.mark.parametrize("algo", ["mh", "mp", "pmp"])
@pytest.mark.parametrize("layout,kernel", [("nhwc", False), ("nhwc", True),
                                           ("packed", False)])
def test_mnist_cnn_run_every_combination(tmp_path, monkeypatch, algo, layout,
                                         kernel):
    """Every algo x layout x cnn_kernel combination pmpx takes runs on the
    synthetic stand-in (Adam warm start, 3 supersteps) to finite losses."""
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    got = tmnist.run(model="CNN", algo=algo, layout=layout,
                     cnn_kernel=kernel, n_train=24, n_test=8, num_steps=3,
                     pretrain_steps=1, out_dir=str(tmp_path / "o"),
                     device="cpu")
    assert set(got) == {"loss_first", "loss_last", "train_acc", "test_acc"}
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("kw", [
    dict(model="FC", cnn_kernel=True),
    dict(model="LSTM", cnn_kernel=True),
    dict(model="CNN", layout="packed", cnn_kernel=True),
    dict(model="CNN", lstm_kernel=True),
])
def test_mnist_run_refuses_what_pmpx_refuses(tmp_path, monkeypatch, kw):
    """pmpx's ValueErrors, word for word."""
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    common = dict(n_train=8, n_test=8, num_steps=1, pretrain_steps=0)
    with pytest.raises(ValueError) as want:
        jmnist.run(out_dir=str(tmp_path / "j"), **common, **kw)
    with pytest.raises(ValueError) as got:
        tmnist.run(out_dir=str(tmp_path / "t"), device="cpu", **common, **kw)
    assert str(got.value) == str(want.value)


def test_mnist_cnn_kernel_chunks_resume_and_never_splice(
        tmp_path, monkeypatch, capsys):
    """The kernel-path chain in chunks, interrupted and resumed, is
    bit-equal to one loop; its sidecar records cnn_kernel and layout; and
    a kernel-path run does not adopt a generic-path prefix (another
    rounding of the densities), while a generic-path run does."""
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    common = dict(model="CNN", algo="pmp", n_train=24, n_test=8,
                  pretrain_steps=1, device="cpu")
    one, cut = str(tmp_path / "one"), str(tmp_path / "cut")
    tmnist.run(num_steps=6, chunk_steps=0, cnn_kernel=True, out_dir=one,
               **common)
    tmnist.run(num_steps=2, chunk_steps=2, cnn_kernel=True, out_dir=cut,
               **common)
    tmnist.run(num_steps=6, chunk_steps=2, cnn_kernel=True, resume=True,
               out_dir=cut, **common)
    stem = "PMP_alpha_0.0001_sample_number_{}CNN_N_7"
    want = load_trace(os.path.join(one, stem.format(6) + ".npz"))["loss"]
    got = load_trace(os.path.join(cut, stem.format(6) + ".npz"))["loss"]
    np.testing.assert_array_equal(got, want)
    with open(os.path.join(cut, stem.format(6) + ".protocol.json")) as f:
        side = json.load(f)
    assert side["cnn_kernel"] is True and side["layout"] == "nhwc"
    # a generic-path prefix of 2 steps: the kernel run does not adopt it
    # (it starts afresh, its one-loop trace), the generic run does
    gen_dir = str(tmp_path / "generic")
    tmnist.run(num_steps=2, chunk_steps=2, out_dir=gen_dir, **common)
    capsys.readouterr()
    tmnist.run(num_steps=6, chunk_steps=2, cnn_kernel=True, resume=True,
               out_dir=gen_dir, **common)
    assert "adopted" not in capsys.readouterr().out
    np.testing.assert_array_equal(load_trace(os.path.join(
        gen_dir, stem.format(6) + ".npz"))["loss"], want)
    tmnist.run(num_steps=4, chunk_steps=2, resume=True, out_dir=gen_dir,
               **common)
    assert "adopted 2-step prefix run" in capsys.readouterr().out
    with open(os.path.join(gen_dir, stem.format(4) + ".protocol.json")) as f:
        assert "cnn_kernel" not in json.load(f)
