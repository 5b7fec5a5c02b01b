"""The port's main path as a whole against pmpx: a PMP chain over linreg
with every superstep's noise replayed from pmpx's key splits; the fused
kernel's scope; and the rule that the port imports neither JAX nor
pmpx."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import run_chain as jrun_chain  # noqa: E402
from pmpx.samplers import pmp as jpmp  # noqa: E402
from pmpx.targets.linreg import BayesLinReg, make_synthetic_linreg  # noqa: E402
from pmpx_torch import run_chain as trun_chain  # noqa: E402
from pmpx_torch.interop import (  # noqa: E402
    linreg_from_numpy, pmp_config_from_jax, theta_from_numpy,
)
from pmpx_torch.kernels import fused_chain as tfc  # noqa: E402
from pmpx_torch.samplers import pmp as tpmp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_chain_replays_pmpx_noise():
    """20 supersteps, n=4096, depth 4, all_first: pmpx with its f32 sweep
    ("xla"), the port with its sweep (the plain version on the CPU), each
    step's eps and uniforms replayed from pmpx's (k_eps, k_draw, k_root,
    k_target) split.  The same root every step; the same states."""
    x, y = make_synthetic_linreg(jax.random.key(0), 4096)
    jt = BayesLinReg(x, y, temper=0.01, method="xla")
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=0.01,
                           method="sweep", device="cpu")
    jcfg = jpmp.PMPConfig(N=1, depth=4, step_size=0.05,
                          selection="all_first")
    tcfg = pmp_config_from_jax(jcfg)
    P, steps = jcfg.P, 20
    key = jax.random.key(42)
    theta0 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    jsup = jpmp.make_superstep(jt, jcfg)
    jfinal, (jstates, jroots) = jax.jit(lambda k, t: jrun_chain(
        jsup, k, t, steps, collect=lambda s, o: (s, o["root_index"])))(
            key, theta0)

    tsup = tpmp.make_superstep(tt, tcfg)
    theta = theta_from_numpy(theta0, device="cpu")
    states, roots = [], []
    for k in jax.random.split(key, steps):  # run_chain's per-step keys
        k_eps, k_draw, _, _ = jax.random.split(k, 4)
        eps = jcfg.step_size * jax.random.normal(k_eps, (P, 3), jnp.float32)
        u = jax.random.uniform(k_draw, (P,), jnp.float32)
        theta, out = tsup(None, theta, eps=torch.tensor(np.array(eps)),
                          u=torch.tensor(np.array(u)))
        states.append(theta)
        roots.append(int(out["root_index"]))
    np.testing.assert_array_equal(roots, np.asarray(jroots))
    assert len(set(roots)) > 1  # the chain moved
    np.testing.assert_allclose(torch.stack(states).numpy(),
                               np.asarray(jstates), rtol=0, atol=1e-5)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jfinal), atol=1e-5)


def test_run_chain_records_and_reproduces():
    x, y = make_synthetic_linreg(jax.random.key(1), 1000)
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=0.05,
                           method="suffstats", device="cpu")
    cfg = tpmp.PMPConfig(N=3, depth=2, step_size=0.1)
    sup = tpmp.make_superstep(tt, cfg)
    runs = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(3)
        runs.append(trun_chain(sup, g, torch.tensor([0.0, 0.0, 1.0]), 6))
    (fa, ra), (fb, rb) = runs
    assert torch.equal(fa, fb)
    assert ra["samples"].shape == (6, 16, 3)
    assert ra["log_accept"].shape == (6, 16)
    assert ra["root_index"].shape == ra["root_logp"].shape == (6,)
    assert torch.equal(ra["samples"], rb["samples"])
    _, pair = trun_chain(sup, g, fa, 3,
                         collect=lambda s, o: (s, o["root_index"]))
    assert pair[0].shape == (3, 3) and pair[1].shape == (3,)
    with pytest.raises(ValueError):
        trun_chain(sup, g, fa, 0)


@pytest.mark.parametrize("selection", ["all_first", "all_uniform", "single"])
def test_superstep_reads_nothing_back_to_the_host(selection):
    """run_chain's design: a superstep enqueues work and never waits for
    the device (no .item(), no indexing with a tensor scalar)."""
    from torch.profiler import ProfilerActivity, profile

    x, y = make_synthetic_linreg(jax.random.key(1), 1000)
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=0.05,
                           method="sweep", device="cpu")
    sup = tpmp.make_superstep(tt, tpmp.PMPConfig(
        N=1, depth=4, step_size=0.1, selection=selection))
    g = torch.Generator()
    g.manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trun_chain(sup, g, torch.tensor([0.0, 0.0, 1.0]), 3)
    names = {e.key for e in prof.key_averages()}
    assert "aten::_local_scalar_dense" not in names
    assert "aten::item" not in names


def test_pmp_config_from_jax_and_dict():
    jcfg = jpmp.PMPConfig(N=3, depth=2, step_size=0.2, trans_sigma=0.5,
                          selection="single", stabilizer="zscore",
                          nan_guard=False)
    a = pmp_config_from_jax(jcfg)
    b = pmp_config_from_jax({"N": 3, "depth": 2, "step_size": 0.2,
                             "trans_sigma": 0.5, "selection": "single",
                             "stabilizer": "zscore", "nan_guard": False})
    assert a == b
    assert (a.N, a.depth, a.P, a.selection) == (3, 2, jcfg.P, "single")
    with pytest.raises(ValueError):
        pmp_config_from_jax({"N": 1, "depth": 2, "step_size": -1.0})


@pytest.mark.parametrize(
    "kw,emit,ok",
    [
        (dict(N=1, depth=10), "root", True),
        (dict(N=1, depth=3), "root", True),
        (dict(N=1, depth=11), "root", False),
        (dict(N=1, depth=9), "all", True),  # emit="all", P = 512
        (dict(N=1, depth=10), "all", False),  # past emit="all"'s cap
        (dict(N=7, depth=1), "root", True),  # flat MP
        (dict(N=3, depth=2), "root", True),  # general (N, depth)
        (dict(N=7, depth=3), "root", True),  # conv_pmp's 512-node cell
        (dict(N=1, depth=4, stabilizer="zscore"), "root", False),
    ],
)
def test_supports_binary_root_only(kw, emit, ok):
    cfg = tpmp.PMPConfig(step_size=0.1, **kw)
    assert tfc.supports(cfg, emit) is ok
    x = np.zeros(8, np.float32)
    tt = linreg_from_numpy(x, x, method="fused", device="cpu")
    if ok:
        assert callable(tfc.make_fused_chain(tt, cfg, emit=emit))
    else:
        with pytest.raises(ValueError):
            tfc.make_fused_chain(tt, cfg, emit=emit)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "pmpx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_imports_no_jax_and_no_pmpx(path):
    banned = ("jax", "jaxlib", "flax", "optax", "pmpx")
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in banned, f"{path.name} imports {name}"
