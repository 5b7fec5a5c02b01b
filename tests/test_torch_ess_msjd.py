"""The port's ESS/MSJD experiment (``pmpx_torch.experiments.ess_msjd``)
against pmpx's: the estimator tail on the same streams, the fused emit-all
cell composed from each package's kernel on the same uniforms, the summary
keys of every path, and the refusals."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.config import SamplerSpec as JSpec  # noqa: E402
from pmpx.experiments import ess_msjd as jem  # noqa: E402
from pmpx.kernels import fused_chain as jfc  # noqa: E402
from pmpx.metrics import autocov_chunked  # noqa: E402
from pmpx.targets.linreg import BayesLinReg, make_synthetic_linreg  # noqa: E402
from pmpx_torch import cli  # noqa: E402
from pmpx_torch.config import SamplerSpec as TSpec  # noqa: E402
from pmpx_torch.experiments import ess_msjd as tem  # noqa: E402
from pmpx_torch.interop import linreg_from_numpy  # noqa: E402
from pmpx_torch.kernels import fused_chain as tfc  # noqa: E402
from pmpx_torch.metrics.recorder import load_trace  # noqa: E402


def _ar1(n, phi, rng):
    e = rng.standard_normal(n)
    x = np.zeros(n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    return x.astype(np.float32)


def _clear_of_zero(x):
    """No Geyer pair of x (float64), up to and including the one that
    stops the sum, within 1e-3 of 0: f32 rounding in either package
    cannot move the truncation."""
    acov = autocov_chunked(x, len(x) - 1)
    pairs = (acov / acov[0])[: 2 * (len(x) // 2)].reshape(-1, 2).sum(1)
    k = int(np.nonzero(pairs <= 0)[0][0])
    return np.abs(pairs[:k + 1]).min() > 1e-3


def _streams(P, num_steps, seed):
    """Roots (num_steps, 3) and P slot columns of AR(1) streams whose
    post-burn-in Geyer pairs all sit clear of 0."""
    rng = np.random.default_rng(seed)
    cols = []
    while len(cols) < P:
        c = _ar1(num_steps, rng.uniform(0.3, 0.9), rng)
        if _clear_of_zero(c[num_steps // 10:]):
            cols.append(c)
    cols = np.stack(cols)
    roots = np.stack([cols[0], _ar1(num_steps, 0.5, rng),
                      1.0 + 0.1 * _ar1(num_steps, 0.5, rng)], axis=1)
    return roots, cols


@pytest.mark.parametrize("P,num_steps", [(6, 3000), (2, (1 << 18) + 300)],
                         ids=["device-fft", "long-stream-chunked"])
def test_finish_emit_cell_matches_pmpx(P, num_steps, tmp_path):
    """Both tails on the same roots, columns and sq_sum: the root ESS, the
    slot ESS sum and the MSJD numerator.  rtol 1e-4 for the f32 FFT
    estimators (the same truncation, no pair near 0), 1e-10 for the
    float64 host estimator of streams of 2^18 steps or more, 1e-5 for
    the root MSJD (an f32 mean)."""
    burn_in = num_steps // 10
    roots, cols = _streams(P, num_steps, P)
    sq_sum = 123.456
    path = str(tmp_path / "cols.npy")
    np.save(path, cols)
    want = jem._finish_emit_cell(roots, cols, path, sq_sum, burn_in,
                                 num_steps, 2.0, True)
    got = tem._finish_emit_cell(roots, cols, path, sq_sum, burn_in,
                                num_steps, 2.0, True, "cpu")
    rtol = 1e-10 if num_steps - burn_in >= (1 << 18) else 1e-4
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)  # root ESS
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)  # root MSJD
    np.testing.assert_allclose(got[2], want[2], rtol=rtol)  # slot ESS
    assert got[3] == want[3] == sq_sum and got[4] == want[4] == 2.0
    tem._finish_emit_cell(roots, cols, path, sq_sum, burn_in, num_steps,
                          2.0, False, "cpu")
    assert not (tmp_path / "cols.npy").exists()  # the spool is removed


def test_fused_emit_all_cell_composed_matches_pmpx(tmp_path, monkeypatch):
    """Each package's ess_msjd._emit_all_cell_fused itself on the same
    uniforms.  pmpx's cell draws them: off the TPU its kernel runs in
    interpret mode with uniforms drawn from each call's key, and a spy
    records the keys.  The port's make_fused_chain is swapped for its
    rng="input" runner fed, call by call, the uniforms pmpx drew from
    the same key (uin from the second split, uemit from the third).  Two
    emit chunks cross a chunk boundary after the burn-in.  Root ESS, root
    MSJD, slot ESS sum and the stitched MSJD numerator agree to rtol 1e-5:
    on these uniforms both kernels draw the same slot at every step, so
    the streams differ only by f32 rounding (~1e-7 apart here), while one
    jump more or less in the numerator's ~6,800 moves it by ~1.5e-4."""
    x, y = make_synthetic_linreg(jax.random.key(1), 2000)
    jt = BayesLinReg(x, y, temper=1.0 / 2000.0, method="fused")
    tt = linreg_from_numpy(np.array(x), np.array(y), temper=1.0 / 2000.0,
                           method="fused", device="cpu")
    spec = dict(algo="pmp", N=1, depth=3, step_size=0.02,
                selection="all_first")
    num_steps, burn_in, emit_chunk = 1000, 150, 500

    calls = []
    j_make = jfc.make_fused_chain

    def spying_make(target, cfg, **kw):
        run = j_make(target, cfg, **kw)

        def spy(key, theta0, n):
            calls.append((key, n))
            return run(key, theta0, n)
        return spy

    monkeypatch.setattr(jfc, "make_fused_chain", spying_make)
    want = jem._emit_all_cell_fused(
        jt, JSpec(**spec), jnp.array([0.0, 0.0, 1.0], jnp.float32),
        num_steps, burn_in, emit_chunk, str(tmp_path / "j"), 0, False, "c")
    assert [n for _, n in calls] == [500, 500, 500]  # warm-up, 2 chunks

    replay = iter(calls)
    t_make = tfc.make_fused_chain

    def replaying_make(target, cfg, *, chunk, emit):
        run = t_make(target, cfg, chunk=chunk, rng="input", emit=emit)
        L = tfc.lane_extent(cfg.P)

        def replayed(generator, theta0, n):
            key, jn = next(replay)
            assert jn == n
            nc = -(-n // chunk)
            _, k_u, k_e = jax.random.split(key, 3)
            uin = 1.0 - np.asarray(
                jax.random.uniform(k_u, (nc, chunk * 17, L), jnp.float32))
            uemit = 1.0 - np.asarray(
                jax.random.uniform(k_e, (nc, chunk, L), jnp.float32))
            return run(generator, theta0, n, uin=torch.tensor(uin),
                       uemit=torch.tensor(uemit))
        return replayed

    monkeypatch.setattr(tfc, "make_fused_chain", replaying_make)
    got = tem._emit_all_cell_fused(
        tt, TSpec(**spec), torch.tensor([0.0, 0.0, 1.0]), num_steps,
        burn_in, emit_chunk, str(tmp_path / "t"), 0, False, "c")
    assert next(replay, None) is None  # the same calls, in the same order
    te, tm_, tae, tam, _ = got
    je, jm, jae, jam, _ = want
    np.testing.assert_allclose(te, je, rtol=1e-5)
    np.testing.assert_allclose(tm_, jm, rtol=1e-5)
    np.testing.assert_allclose(tae, jae, rtol=1e-5)
    np.testing.assert_allclose(tam, jam, rtol=1e-5)
    assert tae > te  # P slot streams carry more ESS than the root path
    assert not list(tmp_path.glob("*/emit_*.npy"))  # spools removed


@pytest.mark.parametrize("burn_in", [50, 60, 0])
def test_emit_all_scan_cell_matches_plain_flattening(burn_in, tmp_path,
                                                     monkeypatch):
    """The port's superstep emit-all cell (ess_msjd._emit_all_cell) against
    a float64 plain reading of the samples its chain collected: a spy on
    run_chain keeps every chunk's (n, P, 3) samples.  The MSJD numerator
    is the sum of squared jumps of the iteration-major flattened stream
    whose earlier element has index >= burn_in * P, to rtol 1e-6 (f32
    sums on the device, per chunk); the spooled columns are the samples'
    b0, bit for bit; the root ESS and MSJD and the slot ESS sum are the
    estimator tail's on those streams, to rtol 1e-6.  Emit chunks of 50
    over 120 steps: burn-in 50 sits on a chunk boundary (not counted),
    60 inside a chunk, 0 counts every boundary."""
    tt = tem.ess_target(512, method="sweep", device="cpu")
    spec = TSpec(algo="pmp", N=1, depth=3, step_size=0.02,
                 selection="all_first")
    num_steps, emit_chunk, P = 120, 50, 8
    seen = []
    run_chain = tem.run_chain

    def spy(*args, **kw):
        out = run_chain(*args, **kw)
        seen.append(out[1].clone())
        return out

    monkeypatch.setattr(tem, "run_chain", spy)
    got = tem._emit_all_cell(tt, spec, torch.tensor([0.0, 0.0, 1.0]),
                             num_steps, burn_in, emit_chunk,
                             str(tmp_path), 0, True, "c")
    assert [s.shape for s in seen] == [(50, P, 3), (50, P, 3), (50, P, 3),
                                       (20, P, 3)]  # warm-up, 3 chunks
    samples = torch.cat(seen[1:]).double().numpy()  # (num_steps, P, 3)
    flat = samples.reshape(-1, 3)
    d = flat[1:] - flat[:-1]
    keep = np.arange(len(d)) >= burn_in * P
    np.testing.assert_allclose(got[3], (d[keep] ** 2).sum(), rtol=1e-6)
    cols = np.load(tmp_path / "emit_c.npy")
    assert np.array_equal(cols, samples[:, :, 0].T.astype(np.float32))
    roots = samples[:, 0, :].astype(np.float32)
    want = tem._finish_emit_cell(roots, cols, str(tmp_path / "emit_c.npy"),
                                 got[3], burn_in, num_steps, got[4], True,
                                 "cpu")
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6)


ROOT_KW = dict(n_data=512, Ps=(8,), num_steps=120, burn_in=20)


@pytest.mark.parametrize("method,trace,extra", [
    ("xla", "root", {}),
    ("fused_chain", "root", {}),
    ("fused_chain", "root", {"chains": 2}),
    ("xla", "all", {"emit_chunk": 50}),
    ("fused_chain", "all", {"num_steps": 40, "burn_in": 8}),
], ids=["scan-root", "fused-root", "fused-root-chains2", "scan-all",
        "fused-all"])
def test_run_keys_match_pmpx(method, trace, extra, tmp_path):
    # both algorithms on the superstep path; one on the fused path, whose
    # pmpx side runs its kernel in interpret mode (1000 steps a launch)
    algos = ("mp",) if method == "fused_chain" else ("mp", "pmp")
    kw = dict(ROOT_KW, algos=algos, method=method, trace=trace, **extra)
    want = jem.run(**kw, out_dir=str(tmp_path / "j"))
    got = tem.run(**kw, out_dir=str(tmp_path / "t"), device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert np.isfinite(v) and v > 0, k
    summary = json.loads((tmp_path / "t" / "summary.json").read_text())
    assert summary == got
    saved = load_trace(str(tmp_path / "t" / "ess_msjd.npz"))
    assert saved["rows"].shape == (len(algos), 3)
    if trace == "root":
        assert saved["root_mean"].shape == (len(algos), 3)
    assert not list((tmp_path / "t").glob("emit_*.npy"))


def test_summary_merges_across_runs(tmp_path):
    a = tem.run(**dict(ROOT_KW, Ps=(4,)), algos=("pmp",), method="sweep",
                out_dir=str(tmp_path), device="cpu")
    b = tem.run(**ROOT_KW, algos=("pmp",), method="sweep",
                out_dir=str(tmp_path), device="cpu")
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary == {**a, **b} and len(summary) == 4


def test_refusals_match_pmpx(tmp_path):
    for kw in (dict(chains=2, method="xla"), dict(chains=2, method="sweep"),
               dict(trace="all", chains=2, method="fused_chain"),
               dict(trace="every")):
        with pytest.raises(ValueError):
            jem.run(n_data=64, Ps=(4,), num_steps=8, out_dir=str(tmp_path),
                    **kw)
        with pytest.raises(ValueError):
            tem.run(n_data=64, Ps=(4,), num_steps=8, out_dir=str(tmp_path),
                    device="cpu", **kw)
    with pytest.raises(ValueError, match="method"):
        tem.run(method="cuda", device="cpu", out_dir=str(tmp_path))


def test_pallas_and_xla_run_the_sweep(tmp_path):
    """pmpx's method names run the port's sweep: the same chain, so the
    same posterior means, as method="sweep"."""
    means = []
    for m in ("sweep", "pallas", "xla"):
        tem.run(**ROOT_KW, algos=("pmp",), method=m,
                out_dir=str(tmp_path / m), device="cpu")
        means.append(load_trace(str(tmp_path / m / "ess_msjd.npz"))[
            "root_mean"])
    np.testing.assert_array_equal(means[0], means[1])
    np.testing.assert_array_equal(means[0], means[2])


def test_cli_runs_ess_msjd(tmp_path, capsys):
    assert cli.main([
        "run", "ess_msjd", "--device", "cpu", "--trace", "all", "--method",
        "fused_chain", "--n_data", "256", "--Ps", "8", "--num_steps", "30",
        "--burn_in", "5", "--algos", "pmp", "--out_dir", str(tmp_path),
    ]) == 0
    out = json.loads(capsys.readouterr().out)
    assert sorted(out) == sorted(
        f"pmp_P8_{k}" for k in ("all_ess_per_s", "all_msjd_per_s",
                                "ess_per_s", "msjd_per_s"))
