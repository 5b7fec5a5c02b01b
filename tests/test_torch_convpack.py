"""The channel-packed conv layout of pmpx_torch (``kernels/convpack.py``,
``models/packed.py``) against pmpx's on the same NumPy inputs, and against
the port's own NHWC models: conv2d, its junk columns, BatchNorm and the
pool; the packed LeNet and MnistCNN forwards and gradients (remat on and
off); and theta interop with torch checkpoints."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from pmpx import interop as jinterop  # noqa: E402
from pmpx.kernels import convpack as jcp  # noqa: E402
from pmpx.models import (  # noqa: E402
    LeNet as JLeNet, MnistCNN as JCNN, PackedLeNet as JPLeNet,
    PackedMnistCNN as JPCNN,
)
from pmpx.targets.nn import NNPosterior as JPost  # noqa: E402
from pmpx_torch import interop as tinterop  # noqa: E402
from pmpx_torch.kernels import convpack as cp  # noqa: E402
from pmpx_torch.models import (  # noqa: E402
    LeNet, MnistCNN, PackedLeNet, PackedMnistCNN,
)
from pmpx_torch.targets.nn import NNPosterior  # noqa: E402

# conv outputs: rtol/atol 1e-5 (pmpx's test_conv2d_matches_lax_conv);
# packed forwards: rtol 2e-4 / atol 2e-5 (pmpx's
# test_packed_forward_equals_flax); densities rtol 1e-5, gradients within
# 1e-4 max|g| (the NHWC LeNet's bound, tests/test_torch_lenet_bnn.py)
CONV_TOL = 1e-5
VAL_RTOL = 1e-5
GRAD_TOL = 1e-4

MODELS = {
    "lenet": (JLeNet, JPLeNet, LeNet, PackedLeNet, (32, 32, 3)),
    "cnn": (JCNN, JPCNN, MnistCNN, PackedMnistCNN, (28, 28)),
}


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("B,H,W,C,O,K", [(3, 14, 14, 6, 16, 5),
                                         (2, 28, 28, 1, 10, 5),
                                         (2, 12, 12, 10, 20, 3)])
def test_conv2d_matches_plain_conv_and_pmpx(B, H, W, C, O, K, remat):
    x, kern, bias = _rand((B, H, W, C), 0), _rand((K, K, C, O), 1, 0.1), \
        _rand((O,), 2)
    packed, g = cp.pack_images(torch.from_numpy(x))
    out, go = cp.conv2d(packed, torch.from_numpy(kern),
                        torch.from_numpy(bias), g, remat=remat)
    assert (go.h, go.w, go.wr) == (H - K + 1, W - K + 1, W)
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(kern).permute(3, 2, 0, 1),
                   torch.from_numpy(bias)).permute(0, 2, 3, 1)
    got = cp.unpack(out, go)
    torch.testing.assert_close(got, ref, rtol=CONV_TOL, atol=CONV_TOL)
    jp, jg = jcp.pack_images(jnp.asarray(x))
    jout, _ = jcp.conv2d(jp, jnp.asarray(kern), jnp.asarray(bias), jg)
    # junk columns included: the same garbage as pmpx's
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               rtol=CONV_TOL, atol=CONV_TOL)


def test_conv2d_ignores_junk_columns():
    """Valid outputs do not depend on the junk columns' values (wr > w)."""
    B, C, O = 2, 4, 8
    g = cp.Grid(h=12, wr=16, w=12)  # 4 junk columns a row
    x = torch.from_numpy(_rand((B, C, g.size), 1))
    kern = torch.from_numpy(_rand((3, 3, C, O), 2, 0.1))
    bias = torch.zeros(O)
    out1, go = cp.conv2d(x, kern, bias, g)
    # poison the junk columns; the valid outputs must not move
    poison = x + 1e6 * (1.0 - cp.valid_mask(g, x.dtype))
    out2, _ = cp.conv2d(poison, kern, bias, g)
    m = cp.valid_mask(go, x.dtype)
    torch.testing.assert_close(out1 * m, out2 * m, rtol=1e-5, atol=1e-4)
    assert not torch.equal(out1, out2)  # the junk did change


def test_pack_unpack_and_mask_match_pmpx():
    x = _rand((2, 6, 8, 3), 3)
    packed, g = cp.pack_images(torch.from_numpy(x))
    jpacked, jg = jcp.pack_images(jnp.asarray(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    assert (g.h, g.wr, g.w) == (jg.h, jg.wr, jg.w) and g.size == 48
    np.testing.assert_array_equal(cp.unpack(packed, g).numpy(), x)
    wide = cp.Grid(4, 6, 3)
    np.testing.assert_array_equal(cp.valid_mask(wide).numpy(),
                                  np.asarray(jcp.valid_mask(jcp.Grid(4, 6,
                                                                     3))))
    y = torch.from_numpy(_rand((2, 5, wide.size), 4))
    np.testing.assert_array_equal(
        cp.unpack(y, wide).numpy(),
        np.asarray(jcp.unpack(jnp.asarray(y.numpy()), jcp.Grid(4, 6, 3))))


def test_batchnorm_matches_pmpx_and_masks_junk(tmp_path):
    g = cp.Grid(h=6, wr=8, w=5)
    x = torch.from_numpy(_rand((3, 4, g.size), 5, 2.0) + 1.0)
    scale, bias = torch.from_numpy(_rand((4,), 6)), torch.from_numpy(
        _rand((4,), 7))
    got = cp.batchnorm(x, scale, bias, g)
    want = jcp.batchnorm(jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()),
                         jnp.asarray(bias.numpy()), jcp.Grid(6, 8, 5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the valid columns normalise to the statistics of the valid columns
    valid = x.reshape(3, 4, 6, 8)[..., :5]
    ref = F.batch_norm(valid, None, None, scale, bias, training=True,
                       eps=1e-5)
    torch.testing.assert_close(got.reshape(3, 4, 6, 8)[..., :5], ref,
                               rtol=1e-5, atol=1e-5)
    poison = x + 1e6 * (1.0 - cp.valid_mask(g))
    again = cp.batchnorm(poison, scale, bias, g)
    m = cp.valid_mask(g)
    torch.testing.assert_close(again * m, got * m, rtol=1e-5, atol=1e-5)
    _sync_batchnorm_matches_pmpx(tmp_path)


def _sync_batchnorm_matches_pmpx(tmp_path):
    """axis_name: 4 gloo ranks, each with 2 of the 8 images, against
    pmpx's batchnorm(axis_name="data") under shard_map on 4 of the 8
    virtual devices: the outputs, and the gradients of sum(out * w) for
    each shard, the scale and the bias; two collectives a forward pass."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from pmpx.parallel import make_mesh as jmake_mesh
    from test_torch_sharded_nn import join_world, spawn_world

    g = cp.Grid(h=6, wr=8, w=5)
    # unequal data on each rank: shard r's mean moves with r
    x = _rand((8, 4, g.size), 9, 2.0) + np.repeat(np.arange(4.0), 2)[
        :, None, None].astype(np.float32)
    w = _rand((8, 4, g.size), 10)
    scale, bias = _rand((4,), 11) + 1.0, _rand((4,), 12)
    jg = jcp.Grid(6, 8, 5)

    def body(x, w, scale, bias):
        def loss(x, scale, bias):
            return (jcp.batchnorm(x, scale, bias, jg, axis_name="data")
                    * w).sum()

        gx, gs, gb = jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)
        return (jcp.batchnorm(x, scale, bias, jg, axis_name="data"), gx,
                jax.lax.psum(gs, "data"), jax.lax.psum(gb, "data"))

    want = jax.jit(shard_map(
        body, mesh=jmake_mesh(chains=1, data=4),
        in_specs=(P("data"), P("data"), P(), P()),
        out_specs=(P("data"), P("data"), P(), P()), check_vma=False))(
        x, w, scale, bias)
    torch.save({"x": torch.from_numpy(x), "w": torch.from_numpy(w),
                "scale": torch.from_numpy(scale),
                "bias": torch.from_numpy(bias), "grid": (6, 8, 5)},
               tmp_path / "bn.pt")
    ranks = join_world(*spawn_world(tmp_path, 4,
                                    "test_torch_sharded_nn:bn_rank",
                                    tmp_path / "bn.pt"))
    y, gx, gs, gb = (np.asarray(a) for a in want)
    for r, res in enumerate(ranks):
        sl = slice(2 * r, 2 * r + 2)
        for got, ref in ((res["y"], y[sl]), (res["gx"], gx[sl]),
                         (res["gscale"], gs), (res["gbias"], gb)):
            np.testing.assert_allclose(got.numpy(), ref, rtol=CONV_TOL,
                                       atol=CONV_TOL)
        assert res["calls"] == 2


def test_max_pool2_matches_pmpx_and_needs_an_even_grid():
    g = cp.Grid(h=6, wr=8, w=6)
    x = torch.from_numpy(_rand((2, 3, g.size), 8))
    out, go = cp.max_pool2(x, g)
    jout, jgo = jcp.max_pool2(jnp.asarray(x.numpy()), jcp.Grid(6, 8, 6))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert (go.h, go.wr, go.w) == (jgo.h, jgo.wr, jgo.w) == (3, 4, 3)
    with pytest.raises(ValueError, match="even grid"):
        cp.max_pool2(x[..., :45], cp.Grid(5, 9, 5))


def _pair(model, B=6, seed=0, remat=True):
    jm, jpm, tm, tpm, shape = MODELS[model]
    X = _rand((B,) + shape, seed)
    Y = np.random.default_rng(seed + 1).integers(0, 10, B).astype(np.int32)
    jpost = JPost(jpm(remat=remat), jnp.asarray(X), jnp.asarray(Y))
    packed = NNPosterior(tpm(remat=remat), X, Y, device="cpu")
    nhwc = NNPosterior(tm(), X, Y, device="cpu")
    return jpost, packed, nhwc


def _thetas(jpost, P, scale=0.05, seed=2):
    t0 = np.asarray(jpost.init_theta())
    return t0 + _rand((P, t0.size), seed, scale)


@pytest.mark.parametrize("model", ["lenet", "cnn"])
def test_packed_shares_the_models_layout(model):
    _, packed, nhwc = _pair(model, B=2)
    assert packed.layout == nhwc.layout
    assert torch.equal(packed.init_theta(), nhwc.init_theta())
    assert isinstance(packed.model, type(nhwc.model))


@pytest.mark.parametrize("model", ["lenet", "cnn"])
def test_packed_forward_equals_nhwc_and_pmpx(model):
    jpost, packed, nhwc = _pair(model)
    theta = _thetas(jpost, 1)[0]
    want = np.asarray(jpost._logits(jnp.asarray(theta), jpost.X))
    with torch.no_grad():
        got = packed._logits(torch.from_numpy(theta), packed.X)
        ref = nhwc._logits(torch.from_numpy(theta), nhwc.X)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("model", ["lenet", "cnn"])
def test_packed_grads_equal_nhwc_and_pmpx(model, remat):
    """value_and_grad_batch through NNPosterior at P = 2: packed against
    pmpx's packed and against the port's NHWC model."""
    jpost, packed, nhwc = _pair(model, remat=remat)
    Theta = _thetas(jpost, 2)
    jv, jg = jpost.value_and_grad_batch(jnp.asarray(Theta))
    tv, tg = packed.value_and_grad_batch(torch.from_numpy(Theta))
    nv, ng = nhwc.value_and_grad_batch(torch.from_numpy(Theta))
    jg = np.asarray(jg)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=VAL_RTOL)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=GRAD_TOL * np.abs(jg).max())
    torch.testing.assert_close(tv, nv, rtol=VAL_RTOL, atol=0)
    torch.testing.assert_close(tg, ng, rtol=0,
                               atol=GRAD_TOL * float(ng.abs().max()))


@pytest.mark.parametrize("wr", [10, 13])
def test_conv2d_remat_is_the_plain_conv_under_vmap_grad(wr):
    """remat's own backward (the slices taken again, tap by tap) gives the
    plain conv's gradients, for x, the kernel and the bias, under
    torch.func.vmap of grad (the proposal axis on the kernel and bias, or
    on all three), with and without junk columns."""
    g = cp.Grid(10, wr, 10)
    X = torch.from_numpy(_rand((4, 3, 2, g.size), 9))
    K = torch.from_numpy(_rand((4, 3, 3, 2, 5), 10, 0.2))
    b = torch.from_numpy(_rand((4, 5), 11))

    def loss(x, k, bb, remat):
        out, _ = cp.conv2d(x, k, bb, g, remat=remat)
        return (out.tanh() ** 2).sum()

    for in_dims in ((None, 0, 0), (0, 0, 0)):
        x = X[0] if in_dims[0] is None else X
        grads = [torch.func.vmap(torch.func.grad(
            lambda a, k, bb, r=r: loss(a, k, bb, r), argnums=(0, 1, 2)),
            in_dims=in_dims)(x, K, b) for r in (True, False)]
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", ["lenet", "cnn", "nhwc_lenet"])
@pytest.mark.parametrize("remat", [True, False])
def test_with_bn_axis_keeps_remat_and_class(model, remat):
    """with_bn_axis(axis), pmpx's one argument: the same class, remat and
    parameter layout, the axis bound; the model it came from unchanged."""
    cls = LeNet if model == "nhwc_lenet" else MODELS[model][3]
    base = cls(remat=remat)
    again = base.with_bn_axis("data")
    assert type(again) is cls and again.remat is remat
    assert again.bn_axis == "data" and base.bn_axis is None
    assert again.flax_layout() == base.flax_layout()
    assert cls(remat=remat, bn_axis="data").bn_axis == "data"
    assert again.with_bn_axis(None).bn_axis is None


def test_packed_cnn_ignores_the_bn_axis():
    """MnistCNN has no BatchNorm: PackedMnistCNN takes an axis and does
    not read it, as pmpx's does (pmpx/models/packed.py:82-87), outside any
    mesh."""
    jpost, packed, _ = _pair("cnn", B=4)
    theta = torch.from_numpy(_thetas(jpost, 1)[0])
    axis = NNPosterior(PackedMnistCNN(bn_axis="data"), packed.X.numpy(),
                       packed.Y.numpy(), device="cpu")
    assert torch.equal(axis.log_prob(theta), packed.log_prob(theta))
    jaxis = JPost(JPCNN(bn_axis="data"), jpost.X, jpost.Y)
    np.testing.assert_allclose(
        float(axis.log_prob(theta)),
        float(jaxis.log_prob(jnp.asarray(theta.numpy()))), rtol=VAL_RTOL)


class _TorchLeNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 6, 5)
        self.b1 = torch.nn.BatchNorm2d(6)
        self.c2 = torch.nn.Conv2d(6, 16, 5)
        self.b2 = torch.nn.BatchNorm2d(16)
        self.f1 = torch.nn.Linear(400, 120)
        self.f2 = torch.nn.Linear(120, 84)
        self.f3 = torch.nn.Linear(84, 10)


class _TorchCNN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(1, 10, 5)
        self.conv2 = torch.nn.Conv2d(10, 20, 3)
        self.fc1 = torch.nn.Linear(2000, 500)
        self.fc2 = torch.nn.Linear(500, 10)


@pytest.mark.parametrize("model", ["lenet", "cnn"])
def test_packed_theta_interop_with_torch_checkpoint(tmp_path, model):
    """theta_from_torch_state lands identically on the packed and NHWC
    posteriors and on pmpx's packed one, and the densities agree."""
    torch.manual_seed(5)
    net = _TorchLeNet() if model == "lenet" else _TorchCNN()
    path = tmp_path / "model.pkl"
    torch.save(net.state_dict(), path)
    jpost, packed, nhwc = _pair(model, B=4)
    sd = tinterop.load_torch_pickle(str(path))
    th_p = tinterop.theta_from_torch_state(packed, sd)
    th_n = tinterop.theta_from_torch_state(nhwc, sd)
    assert torch.equal(th_p, th_n)
    want = np.asarray(jinterop.theta_from_torch_state(
        jpost, jinterop.load_torch_pickle(str(path))))
    np.testing.assert_array_equal(th_p.numpy(), want)
    np.testing.assert_allclose(float(packed.log_prob(th_p)),
                               float(jpost.log_prob(jnp.asarray(want))),
                               rtol=VAL_RTOL)
    np.testing.assert_allclose(float(packed.log_prob(th_p)),
                               float(nhwc.log_prob(th_n)), rtol=VAL_RTOL)
