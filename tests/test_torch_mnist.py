"""The MNIST-LSTM slice of the port against pmpx: the data loader on the
same files, the synthetic stand-in's law, torch-checkpoint interop, the
Adam warm start, a PMP chain over the kernel-attached LSTM posterior
replaying pmpx's noise, and ``mnist.run`` end to end.  Inputs are drawn
with numpy from a seed and written where both packages read them."""

import gzip
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import interop as jinterop  # noqa: E402
from pmpx import run_chain as jrun_chain  # noqa: E402
from pmpx.data import load_mnist as jload_mnist  # noqa: E402
from pmpx.experiments import mnist as jmnist  # noqa: E402
from pmpx.kernels import lstm_fused as jlf  # noqa: E402
from pmpx.models import MnistLSTM as JLSTM, MnistMLP as JMLP  # noqa: E402
from pmpx.samplers import pmp as jpmp  # noqa: E402
from pmpx.targets.nn import NNPosterior as JPost  # noqa: E402
from pmpx_torch import data as tdata  # noqa: E402
from pmpx_torch import interop as tinterop  # noqa: E402
from pmpx_torch.experiments import mnist as tmnist  # noqa: E402
from pmpx_torch.kernels import launches  # noqa: E402
from pmpx_torch.kernels import lstm_fused as tlf  # noqa: E402
from pmpx_torch.models import MnistLSTM, MnistMLP  # noqa: E402
from pmpx_torch.samplers import pmp as tpmp  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402


def _raw_mnist(n_train, n_test, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n_train, 28, 28), dtype=np.uint8),
            rng.integers(0, 10, n_train).astype(np.uint8),
            rng.integers(0, 256, (n_test, 28, 28), dtype=np.uint8),
            rng.integers(0, 10, n_test).astype(np.uint8))


def _write_npz(path, arrays):
    np.savez(path / "mnist.npz", **dict(zip(
        ("x_train", "y_train", "x_test", "y_test"), arrays)))


def _write_idx(path, name, a, gz=False):
    head = struct.pack(">HBB", 0, 0x08, a.ndim) + struct.pack(
        f">{a.ndim}I", *a.shape)
    opener = gzip.open if gz else open
    with opener(path / (name + (".gz" if gz else "")), "wb") as f:
        f.write(head + a.tobytes())


def _assert_same(tout, jout):
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tout[0].dtype == torch.float32 and tout[1].dtype == torch.int64


@pytest.mark.parametrize("fmt", ["npz", "idx", "idx_gz_raw"])
def test_load_mnist_reads_the_same_files_as_pmpx(tmp_path, monkeypatch,
                                                 fmt):
    """The same npz or IDX files (plain, or gzipped in torchvision's
    MNIST/raw/) give bit-equal arrays, normalised and sliced as pmpx does,
    with label noise drawn by each package's own generator."""
    raw = _raw_mnist(50, 20)
    if fmt == "npz":
        _write_npz(tmp_path, raw)
    else:
        d = tmp_path / "MNIST" / "raw" if fmt == "idx_gz_raw" else tmp_path
        d.mkdir(parents=True, exist_ok=True)
        for name, a in zip(tdata._IDX_NAMES, raw):
            _write_idx(d, name, a, gz=fmt == "idx_gz_raw")
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    _assert_same(tdata.load_mnist(40, 16, device="cpu"),
                 jload_mnist(n_train=40, n_test=16))
    pres = tdata.dataset_presence()
    assert pres["mnist_npz"] == (fmt == "npz")
    assert pres["mnist_idx"] == (fmt != "npz")
    noisy = tdata.load_mnist(40, 16, label_noise=0.5, device="cpu")
    clean = tdata.load_mnist(40, 16, device="cpu")
    assert torch.equal(noisy[0], clean[0])
    assert (noisy[1] != clean[1]).any()


def test_malformed_files_fail_loudly_like_pmpx(tmp_path, monkeypatch):
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    np.savez(tmp_path / "mnist.npz", x_train=np.zeros((2, 28, 28)))
    for load in (lambda: tdata.load_mnist(2, 2, device="cpu"),
                 lambda: jload_mnist(2, 2)):
        with pytest.raises(ValueError, match="missing arrays"):
            load()
    (tmp_path / "mnist.npz").unlink()
    raw = _raw_mnist(4, 4)
    for name, a in zip(tdata._IDX_NAMES, raw):
        _write_idx(tmp_path, name, a)
    with open(tmp_path / tdata._IDX_NAMES[0], "r+b") as f:
        f.truncate(100)
    for load in (lambda: tdata.load_mnist(2, 2, device="cpu"),
                 lambda: jload_mnist(2, 2)):
        with pytest.raises(ValueError, match="truncated"):
            load()


def test_synthetic_stand_in_shapes_and_law(tmp_path, monkeypatch):
    """No data on disk: MNIST's shapes; uniform labels; images = class
    prototype x class_sep + unit noise; reproducible from the seed."""
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    x_tr, y_tr, x_te, y_te = tdata.load_mnist(6000, 1000, class_sep=1.5,
                                              device="cpu")
    assert x_tr.shape == (6000, 28, 28) and x_te.shape == (1000, 28, 28)
    assert x_tr.dtype == torch.float32 and y_tr.dtype == torch.int64
    counts = torch.bincount(y_tr, minlength=10).double()
    # multinomial counts: each within 5 sd of n/10
    assert ((counts - 600).abs() <= 5 * np.sqrt(6000 * 0.09)).all()
    protos = torch.stack([x_tr[y_tr == k].mean(0) for k in range(10)])
    resid = x_tr - protos[y_tr]
    assert abs(resid.std().item() - 1.0) < 0.02
    assert abs(protos.std().item() - 1.5) < 0.1
    # the test split shares the prototypes
    np.testing.assert_allclose(
        torch.stack([x_te[y_te == k].mean(0) for k in range(10)]).numpy(),
        protos.numpy(), atol=0.5)
    again = tdata.load_mnist(6000, 1000, class_sep=1.5, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(again, (x_tr, y_tr, x_te, y_te)))
    noisy = tdata.load_mnist(6000, 1000, label_noise=0.3, device="cpu")
    flipped = (noisy[1] != y_tr).double().mean().item()
    assert abs(flipped - 0.3 * 0.9) < 0.03  # a flip keeps 1 in 10 labels


class _TorchLSTM(torch.nn.Module):
    """The reference's LSTM model (PMP_LSTM.py:22-43): nn.LSTM + Linear."""

    def __init__(self):
        super().__init__()
        self.lstm = torch.nn.LSTM(28, 64, batch_first=True)
        self.fc = torch.nn.Linear(64, 10)


def _torch_mlp():
    return torch.nn.Sequential(
        torch.nn.Flatten(), torch.nn.Linear(784, 512), torch.nn.ReLU(),
        torch.nn.Linear(512, 256), torch.nn.ReLU(),
        torch.nn.Linear(256, 128), torch.nn.ReLU(),
        torch.nn.Linear(128, 10))


def _pickle(tmp_path, model, seed=0):
    torch.manual_seed(seed)
    net = _TorchLSTM() if model == "LSTM" else _torch_mlp()
    path = tmp_path / f"{model}_model.pkl"
    torch.save(net.state_dict(), path)
    return str(path)


@pytest.mark.parametrize("model", ["LSTM", "FC"])
def test_theta_from_torch_state_matches_pmpx(tmp_path, model):
    """A torch state dict saved with torch.save maps to the same theta in
    both packages (b_ih + b_hh on the hidden-side bias, Linear weights
    transposed, layers matched by kind)."""
    path = _pickle(tmp_path, model)
    X = np.zeros((2, 28, 28), np.float32)
    jm, tm = (JLSTM, MnistLSTM) if model == "LSTM" else (JMLP, MnistMLP)
    jpost = JPost(jm(), jnp.asarray(X), jnp.zeros(2, jnp.int32))
    tpost = NNPosterior(tm(), X, np.zeros(2), device="cpu")
    want = np.asarray(jinterop.theta_from_torch_state(
        jpost, jinterop.load_torch_pickle(path)))
    got = tinterop.theta_from_torch_state(
        tpost, tinterop.load_torch_pickle(path))
    np.testing.assert_array_equal(got.numpy(), want)
    params = jax.tree.map(np.asarray, jpost._unravel(jnp.asarray(want)))
    assert torch.equal(tinterop.nn_theta_from_params(tpost, params), got)
    state = tinterop.load_torch_pickle(path)
    state.pop(next(iter(state)))
    with pytest.raises((ValueError, KeyError)):
        tinterop.theta_from_torch_state(tpost, state)


@pytest.mark.parametrize("shape,match", [((4, 1, 3, 3), "expects a .dense"),
                                         ((4,), "expects a .dense")])
def test_theta_from_torch_state_refuses_conv_and_norm_layers(shape, match):
    X = np.zeros((2, 28, 28), np.float32)
    tpost = NNPosterior(MnistMLP(), X, np.zeros(2), device="cpu")
    # an MLP has no conv or BatchNorm module for them (LeNet's mapping is
    # tests/test_torch_lenet_bnn.py's)
    state = {"layer.weight": np.zeros(shape, np.float32),
             "layer.bias": np.zeros(4, np.float32)}
    with pytest.raises(ValueError, match=match):
        tinterop.theta_from_torch_state(tpost, state)


def _posteriors(model="LSTM", B=48, temper=10.0, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, 28, 28)).astype(np.float32)
    Y = rng.integers(0, 10, B).astype(np.int32)
    jm, tm = (JLSTM, MnistLSTM) if model == "LSTM" else (JMLP, MnistMLP)
    jpost = JPost(jm(), jnp.asarray(X), jnp.asarray(Y), temper=temper)
    tpost = NNPosterior(tm(), X, Y, temper=temper, device="cpu")
    # the same start on both sides: pmpx's initial theta
    tpost._theta0 = torch.tensor(np.asarray(jpost._theta0))
    return jpost, tpost


@pytest.mark.parametrize("model", ["LSTM", "FC"])
def test_pretrain_matches_pmpx(model):
    """3 Adam steps (lr 1e-3) from the same theta0: torch.optim.Adam
    against optax.adam, the same update rule.  LSTM (smooth activations):
    states within 2e-5, loss within rtol 1e-5.  FC (ReLU): one step agrees
    within 2e-5 wherever |grad| >= 1e-6 (measured 7.8e-8), but some
    gradients are zero to within f32 rounding, and from the second step
    Adam's lr*m/(sqrt(v)+eps) turns their rounding into steps of up to lr
    either way; so after 3 steps the states are held within 3 * 2 * lr =
    6e-3 and the loss within rtol 2e-3 (measured 2.2e-3, 4.1e-4)."""
    jpost, tpost = _posteriors(model)
    want = np.asarray(jmnist.pretrain(jpost, 3))
    got = tmnist.pretrain(tpost, 3)
    assert not got.requires_grad
    loss_t = float(tpost.log_prob(got))
    loss_j = float(jpost.log_prob(jnp.asarray(want)))
    if model == "LSTM":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    else:
        g = np.asarray(jax.grad(lambda t: -jpost.log_prob(t))(
            jpost._theta0))
        clear = np.abs(g) >= 1e-6
        one_j = np.asarray(jmnist.pretrain(jpost, 1))
        one_t = tmnist.pretrain(tpost, 1).numpy()
        np.testing.assert_allclose(one_t[clear], one_j[clear], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=6e-3)
        np.testing.assert_allclose(loss_t, loss_j, rtol=2e-3)
    assert torch.equal(tmnist.pretrain(tpost, 0), tpost.init_theta())


def test_pmp_chain_over_lstm_kernel_replays_pmpx_noise():
    """10 PMP supersteps (binary depth 3, all_first, zscore) over the LSTM
    posterior with the kernel attached on both sides (pmpx's in interpret
    mode), every superstep's eps and uniforms replayed from pmpx's key
    splits: the same roots, states within 1e-5."""
    jpost, tpost = _posteriors(B=64, seed=2)
    jlf.attach(jpost, block_b=64, interpret=True)
    tlf.attach(tpost)
    jcfg = jpmp.PMPConfig(N=1, depth=3, step_size=0.02,
                          selection="all_first", stabilizer="zscore")
    tcfg = tpmp.PMPConfig(N=1, depth=3, step_size=0.02,
                          selection="all_first", stabilizer="zscore")
    P, d, steps = jcfg.P, jpost.d, 10
    key = jax.random.key(7)
    theta0 = jpost._theta0
    jsup = jpmp.make_superstep(jpost, jcfg)
    jfinal, (jstates, jroots) = jax.jit(lambda k, t: jrun_chain(
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


CELLS = [("LSTM", "pmp", True), ("LSTM", "pmp", False), ("FC", "mh", False),
         ("FC", "mp", False), ("FC", "pmp", False)]


@pytest.mark.parametrize("model,algo,kernel", CELLS)
def test_mnist_run_matches_pmpx(tmp_path, monkeypatch, model, algo, kernel):
    """mnist.run end to end on the same npz and the same warm-start
    pickle: the same summary keys; loss_first and loss_last within rtol
    1e-3 (the chains draw different noise, alpha = 1e-4 keeps every state
    within ~1e-4 of the shared start); accuracies within 2 of 32 test
    examples.  The kernel cell launches nothing on the CPU."""
    _write_npz(tmp_path, _raw_mnist(64, 32, seed=1))
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    ws = _pickle(tmp_path, model, seed=3)
    kw = dict(model=model, algo=algo, num_steps=4, n_train=64, n_test=32,
              warm_start=ws, lstm_kernel=kernel)
    want = jmnist.run(out_dir=str(tmp_path / "j"), **kw)
    before = dict(launches)
    got = tmnist.run(out_dir=str(tmp_path / "t"), device="cpu", **kw)
    assert launches == before
    assert set(got) == set(want)
    for k in ("loss_first", "loss_last"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3)
    for k in ("train_acc", "test_acc"):
        assert abs(got[k] - want[k]) <= 2 / 32
    stem = f"{algo.upper()}_alpha_0.0001_sample_number_4{model}_N_7"
    saved = np.load(tmp_path / "t" / f"{stem}.npz")
    assert saved["loss"].shape == (4,)


def test_mnist_run_pretrain_path_and_cli(tmp_path, monkeypatch, capsys):
    """The Adam warm start in run() and the CLI entry of the slice on the
    synthetic stand-in (no data on disk)."""
    from pmpx_torch import cli

    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    assert cli.main(["run", "mnist", "--device", "cpu", "--model", "LSTM",
                     "--lstm_kernel", "true", "--n_train", "32",
                     "--n_test", "16", "--num_steps", "3",
                     "--pretrain_steps", "2",
                     "--out_dir", str(tmp_path / "o")]) == 0
    out = capsys.readouterr().out
    import json
    res = json.loads(out)
    assert set(res) == {"loss_first", "loss_last", "train_acc", "test_acc"}
    assert all(np.isfinite(v) for v in res.values())


@pytest.mark.parametrize("kw", [
    dict(model="CNN"),
    dict(layout="packed"),
    dict(cnn_kernel=True),
    dict(model="CNN", chunk_steps=2),
    dict(layout="packed", resume=True, chunk_steps=2),
])
def test_mnist_run_cnn_options_as_pmpx(tmp_path, monkeypatch, kw):
    """The CNN's options run where pmpx runs them (FC ignores ``layout``,
    as pmpx's MODELS do) and raise pmpx's error where pmpx raises
    (``cnn_kernel`` on FC, the default model)."""
    monkeypatch.setenv("PMPX_DATA_DIR", str(tmp_path))
    common = dict(n_train=16, n_test=8, num_steps=4, pretrain_steps=1, **kw)
    if kw.get("cnn_kernel"):
        with pytest.raises(ValueError) as want:
            jmnist.run(out_dir=str(tmp_path / "j"), **common)
        with pytest.raises(ValueError, match="requires --model CNN") as got:
            tmnist.run(out_dir=str(tmp_path / "t"), device="cpu", **common)
        assert str(got.value) == str(want.value)
        return
    got = tmnist.run(out_dir=str(tmp_path / "t"), device="cpu", **common)
    assert np.isfinite(got["loss_last"])
    if kw.get("chunk_steps"):
        assert got["steady_ms_per_superstep"] > 0


def test_mnist_run_rejects_lstm_kernel_on_fc():
    with pytest.raises(ValueError, match="requires --model LSTM"):
        tmnist.run(model="FC", lstm_kernel=True, n_train=8, n_test=8,
                   device="cpu")
