"""The port's NN posterior against pmpx's: the flat-theta layout leaf by
leaf, the densities and gradients on the same theta and data, proposal
chunking, bf16, and the initialisers' law.  Inputs are drawn with numpy
from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.models import MnistLSTM as JLSTM, MnistMLP as JMLP  # noqa: E402
from pmpx.targets.nn import NNPosterior as JPost  # noqa: E402
from pmpx_torch.models import MnistLSTM, MnistMLP  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402

MODELS = {"LSTM": (JLSTM, MnistLSTM), "FC": (JMLP, MnistMLP)}


def _data(B, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, 28, 28)).astype(np.float32)
    Y = rng.integers(0, 10, B).astype(np.int32)
    return X, Y


def _pair(model, B=48, temper=10.0, compute_dtype=None, seed=0, **kw):
    X, Y = _data(B, seed)
    jm, tm = MODELS[model]
    jpost = JPost(jm(), jnp.asarray(X), jnp.asarray(Y), temper=temper,
                  compute_dtype=None if compute_dtype is None
                  else jnp.bfloat16)
    tpost = NNPosterior(tm(), X, Y, temper=temper, device="cpu",
                        compute_dtype=None if compute_dtype is None
                        else torch.bfloat16, **kw)
    return jpost, tpost


def _thetas(jpost, P, scale=0.05, seed=1):
    rng = np.random.default_rng(seed)
    th0 = np.asarray(jpost._theta0)
    return th0 + scale * rng.standard_normal((P, th0.size)).astype(
        np.float32)


@pytest.mark.parametrize("model,d", [("LSTM", 24_458), ("FC", 567_434)])
def test_theta_layout_matches_pmpx_leaf_by_leaf(model, d):
    """Every leaf of pmpx's _unravel (flax's ravel_pytree order) is the
    same slice of theta in the port's unravel, and ravel inverts it."""
    jpost, tpost = _pair(model, B=4)
    assert tpost.d == jpost.d == d
    theta = np.random.default_rng(3).standard_normal(d).astype(np.float32)
    jleaves = traverse_util.flatten_dict(
        jax.tree.map(np.asarray, jpost._unravel(jnp.asarray(theta))),
        sep=".")
    tleaves = tpost.unravel(torch.tensor(theta))
    assert list(tleaves) == sorted(jleaves)  # ravel_pytree's order
    for path, leaf in jleaves.items():
        np.testing.assert_array_equal(tleaves[path].numpy(), leaf)
    assert torch.equal(tpost.ravel(tleaves), torch.tensor(theta))
    assert torch.equal(tpost.theta_from_params(
        jax.tree.map(np.asarray, jpost._unravel(jnp.asarray(theta)))),
        torch.tensor(theta))


def test_lstm_layout_offsets():
    """The offsets of the flat LSTM theta (gates f, g, i, o in theta)."""
    _, tpost = _pair("LSTM", B=4)
    offs = {p: o for p, (o, _, _) in tpost._slices.items()}
    cell = "OptimizedLSTMCell_0"
    assert offs["Dense_0.bias"] == 0 and offs["Dense_0.kernel"] == 10
    assert [offs[f"{cell}.h{g}.bias"] for g in "fgio"] == [
        650, 4810, 8970, 13130]
    assert offs[f"{cell}.if.kernel"] == 17290


@pytest.mark.parametrize("model", ["LSTM", "FC"])
def test_log_prob_batch_and_grads_match_pmpx(model):
    """Densities within rtol 1e-5 (f32 on the CPU, another summation
    order; measured equal for the LSTM); gradients within 1e-5 of
    max|grad| (autograd against jax.grad)."""
    jpost, tpost = _pair(model)
    Theta = _thetas(jpost, 3)
    want = np.asarray(jpost.log_prob_batch(jnp.asarray(Theta)))
    got = tpost.log_prob_batch(torch.tensor(Theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jv, jg = jpost.value_and_grad_batch(jnp.asarray(Theta))
    tv, tg = tpost.value_and_grad_batch(torch.tensor(Theta))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())
    single = tpost.log_prob(torch.tensor(Theta[1]))
    np.testing.assert_allclose(float(single), want[1], rtol=1e-5)


def test_proposal_chunk_equals_no_chunking():
    """vmap's chunk_size=2 over P=4 against one vmap: within rtol 1e-6
    (chunked batched matmuls may sum in another order); a chunk that does
    not divide P raises, as in pmpx."""
    jpost, full = _pair("LSTM", B=32)
    _, chunked = _pair("LSTM", B=32, proposal_chunk=2)
    Theta = torch.tensor(_thetas(jpost, 4))
    np.testing.assert_allclose(chunked.log_prob_batch(Theta).numpy(),
                               full.log_prob_batch(Theta).numpy(),
                               rtol=1e-6)
    v1, g1 = chunked.value_and_grad_batch(Theta)
    v2, g2 = full.value_and_grad_batch(Theta)
    np.testing.assert_allclose(v1.numpy(), v2.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0,
                               atol=1e-6 * float(g2.abs().max()))
    with pytest.raises(ValueError, match="must divide"):
        chunked.log_prob_batch(Theta[:3])


@pytest.mark.parametrize("model", ["LSTM", "FC"])
def test_bf16_close_to_pmpx(model):
    """compute_dtype bf16 on both sides: the port promotes as flax does
    (the LSTM carry stays f32), so densities agree within rtol 1e-4 (bf16
    products rounded in the same places; measured ~1e-7 for the LSTM),
    and within rtol 0.02 / atol 0.05 of f32 (pmpx's bf16 gate)."""
    jpost, tpost = _pair(model, compute_dtype="bf16")
    _, t32 = _pair(model)
    Theta = _thetas(jpost, 2)
    want = np.asarray(jpost.log_prob_batch(jnp.asarray(Theta)))
    got = tpost.log_prob_batch(torch.tensor(Theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    f32 = t32.log_prob_batch(torch.tensor(Theta)).numpy()
    np.testing.assert_allclose(got, f32, rtol=0.02, atol=0.05)
    assert tpost.X.dtype == torch.bfloat16


def test_stochastic_raises():
    """A deterministic model takes no weight noise: stochastic=True over
    it raises (BayesMLP's stochastic posterior is
    tests/test_torch_lenet_bnn.py's)."""
    X, Y = _data(4)
    with pytest.raises(ValueError, match="noise_shapes"):
        NNPosterior(MnistMLP(), X, Y, stochastic=True, device="cpu")


def test_accuracy_and_bound_data_match_pmpx():
    jpost, tpost = _pair("LSTM", B=40)
    theta = _thetas(jpost, 1)[0]
    X2, Y2 = _data(24, seed=5)
    want = float(jpost.accuracy(jnp.asarray(theta), jnp.asarray(X2),
                                jnp.asarray(Y2)))
    got = float(tpost.accuracy(torch.tensor(theta), torch.tensor(X2),
                               torch.tensor(Y2).long()))
    assert got == want
    with tpost.bound_data(torch.tensor(X2), torch.tensor(Y2).long()):
        assert tpost.X.shape[0] == 24
        with pytest.raises(RuntimeError, match="reentrant"):
            with tpost.bound_data(torch.tensor(X2)):
                pass
    assert tpost.X.shape[0] == 40


def _law_check(leaf, init, shape):
    """One leaf against flax's initialiser law: zeros; lecun_normal
    (truncated at 2 sd of the underlying normal, variance 1/fan_in);
    orthogonal (W^T W = I)."""
    if init == "zeros":
        assert not leaf.any()
    elif init == "orthogonal":
        np.testing.assert_allclose(leaf.T @ leaf, np.eye(shape[1]),
                                   atol=1e-5)
    else:
        fan_in = shape[0]
        sd = np.sqrt(1.0 / fan_in)
        assert np.abs(leaf).max() <= 2.0 * sd / 0.87962566103423978 + 1e-7
        n = leaf.size
        # the sample sd of n draws: within 6 standard errors (sd/sqrt(2n))
        assert abs(leaf.std() - sd) <= 6 * sd / np.sqrt(2 * n)
        assert abs(leaf.mean()) <= 6 * sd / np.sqrt(n)


@pytest.mark.parametrize("model", ["LSTM", "FC"])
def test_init_theta_follows_flax_initialisers(model):
    """Each leaf of the port's init_theta and of pmpx's follows the same
    law (the numbers differ: torch.Generator against jax.random)."""
    jpost, tpost = _pair(model, B=4)
    tleaves = tpost.unravel(tpost.init_theta())
    jleaves = traverse_util.flatten_dict(
        jax.tree.map(np.asarray, jpost._unravel(jpost._theta0)), sep=".")
    for path, shape, init in tpost.layout:
        _law_check(tleaves[path].numpy(), init, shape)
        _law_check(jleaves[path], init, shape)
    again = NNPosterior(MODELS[model][1](), *_data(4), device="cpu")
    assert torch.equal(again.init_theta(), tpost.init_theta())
    other = NNPosterior(MODELS[model][1](), *_data(4), seed=1, device="cpu")
    assert not torch.equal(other.init_theta(), tpost.init_theta())
