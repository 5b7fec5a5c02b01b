"""The port's linreg and analytic experiments (error_boxplot, banana,
lb_grid, convergence, correlation, skewness, multichain) beside pmpx's on
the same arguments, at pmpx's own test sizes: the same summary keys, the
same saved files and array shapes, and statistical agreement (the port
draws its own streams).  Tail means are held to the least-squares fit of
the port's data within 4 posterior sd (``pmpx_torch.bench.least_squares``:
the tempered posterior's sd, sigma at its estimate)."""

import csv
import json
import os

import jax
import numpy as np
import pytest
from scipy import stats

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx.experiments import _common as jcommon  # noqa: E402
from pmpx.experiments import banana as jban  # noqa: E402
from pmpx.experiments import convergence as jconv  # noqa: E402
from pmpx.experiments import correlation as jcorr  # noqa: E402
from pmpx.experiments import error_boxplot as jerr  # noqa: E402
from pmpx.experiments import lb_grid as jlb  # noqa: E402
from pmpx.experiments import multichain as jmc  # noqa: E402
from pmpx.experiments import skewness as jskew  # noqa: E402
from pmpx_torch import cli  # noqa: E402
from pmpx_torch.bench import least_squares  # noqa: E402
from pmpx_torch.experiments import _common as tcommon  # noqa: E402
from pmpx_torch.experiments import banana as tban  # noqa: E402
from pmpx_torch.experiments import convergence as tconv  # noqa: E402
from pmpx_torch.experiments import correlation as tcorr  # noqa: E402
from pmpx_torch.experiments import error_boxplot as terr  # noqa: E402
from pmpx_torch.experiments import lb_grid as tlb  # noqa: E402
from pmpx_torch.experiments import multichain as tmc  # noqa: E402
from pmpx_torch.experiments import skewness as tskew  # noqa: E402
from pmpx_torch.experiments._common import seeded  # noqa: E402
from pmpx_torch.targets.linreg import (  # noqa: E402
    BayesLinReg, make_synthetic_linreg,
)

Z_MAX = 4.0  # tail means within 4 posterior sd of the least-squares fit
# pmpx's value as one draw of the port's law: within Z_PRED sd of the mean
# of the port's runs at seeds 0..K_SEEDS-1 (a prediction interval, the
# sd widened by sqrt(1 + 1/K_SEEDS)); the port draws its own data and
# chains at each seed, as pmpx's run draws its own
Z_PRED, K_SEEDS = 4.0, 8
# the wrappers on the same stand-in samples: NumPy/f32 reductions of the
# same numbers on both sides
WRAP_RTOL, WRAP_ATOL = 1e-6, 1e-5


def _both(jmod, tmod, tmp_path, **kw):
    """pmpx's and the port's run() on the same arguments, each writing to
    its own directory: (pmpx's summary, the port's, their directories)."""
    jd, td = tmp_path / "j", tmp_path / "t"
    want = jmod.run(out_dir=str(jd), **kw)
    got = tmod.run(out_dir=str(td), device="cpu", **kw)
    return want, got, jd, td


def _same_files(jd, td, name):
    """The same files, and the same arrays and shapes in the trace
    ``name``'s manifest."""
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    arrays = [json.loads((d / f"{name}.json").read_text())["arrays"]
              for d in (jd, td)]
    assert arrays[1] == arrays[0]


def _z(means, n_data, temper, seed=0):
    """|mean - fit| / sd per coordinate, on the data the port's run drew."""
    x, y = make_synthetic_linreg(seeded(seed, "cpu"), n_data)
    fit, sd = least_squares(BayesLinReg(x, y, temper=temper, device="cpu"))
    return (torch.tensor(means, dtype=torch.float64) - fit[:len(means)]
            ).abs() / sd[:len(means)]


def _port_spread(tmod, tmp_path, stat, **kw):
    """``stat(summary, out_dir)`` -> a vector, over the port's runs at
    seeds 0..K_SEEDS-1: (mean, sd) per entry."""
    v = []
    for seed in range(K_SEEDS):
        d = tmp_path / f"seed{seed}"
        v.append(stat(tmod.run(out_dir=str(d), device="cpu", seed=seed,
                               **kw), d))
    v = np.asarray(v, dtype=np.float64)
    return v.mean(axis=0), v.std(axis=0, ddof=1)


def _within_port_spread(want, spread, what):
    mean, sd = spread
    bound = Z_PRED * sd * np.sqrt(1 + 1 / K_SEEDS)
    dev = np.abs(np.asarray(want, dtype=np.float64) - mean)
    assert bool((dev <= bound).all()), (what, want, mean, bound)


class _StandIn:
    """Stands in for one package's chain runner under an experiment: it
    records each ``SamplerSpec``'s fields, each target's arguments and
    each run's start state and step count, and returns stand-in samples
    (``SAMPLES_A_STEP`` a superstep) that are the same for both packages:
    run i draws from NumPy's seed i.  So the two experiments' wrappers
    (start states, depths, slices, burn-in, pooling, statistics) meet
    the same numbers."""

    SAMPLES_A_STEP = 4

    def __init__(self, to_array):
        self.to_array, self.specs, self.targets, self.runs = to_array, [], [], []

    def spec(self, cls):
        def make(**kw):
            self.specs.append(kw)
            return cls(**kw)
        return make

    def target(self, cls):
        def make(x, y, **kw):
            self.targets.append((np.asarray(x).shape, {
                k: v for k, v in kw.items() if k != "device"}))
            return cls(x, y, **kw)
        return make

    def _draw(self, theta0, num_steps, shape):
        self.runs.append((np.array(theta0, dtype=np.float32), num_steps))
        rng = np.random.default_rng(len(self.runs))
        return rng.normal(size=shape).astype(np.float32)

    def run_chain(self, superstep, key, theta0, num_steps, **_):
        d = np.asarray(theta0).shape[-1]
        s = self._draw(theta0, num_steps,
                       (num_steps, self.SAMPLES_A_STEP, d))
        return None, {"samples": self.to_array(s)}

    def run_chains(self, superstep, keys, theta0, num_steps, collect):
        s = self._draw(theta0, num_steps, (*np.asarray(theta0).shape[:1],
                                           num_steps, theta0.shape[-1]))
        return None, collect(self.to_array(s), {})


def _stand_ins(monkeypatch, jmod, tmod, runner, targets=False):
    """A stand-in for each package under ``jmod``/``tmod``: pmpx's jit is
    the identity (its runs are the stand-in's Python), and ``runner``
    ("run_chain" in each module's namespace, "run_chains_vmapped", or
    "collect" for ``_common``'s run_chain) is replaced."""
    monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
    sides = {}
    for tag, mod, common, to_array in (
            ("j", jmod, jcommon, np.asarray),
            ("t", tmod, tcommon, torch.from_numpy)):
        st = _StandIn(to_array)
        monkeypatch.setattr(mod, "SamplerSpec", st.spec(mod.SamplerSpec))
        if targets:
            monkeypatch.setattr(mod, "BayesLinReg",
                                st.target(mod.BayesLinReg))
        if runner == "collect":
            monkeypatch.setattr(common, "run_chain", st.run_chain)
        elif runner == "run_chain":
            monkeypatch.setattr(mod, "run_chain", st.run_chain)
        else:
            monkeypatch.setattr(mod, runner, st.run_chains)
        sides[tag] = st
    return sides["j"], sides["t"]


def _same_calls(js, ts):
    assert ts.specs == js.specs
    assert ts.targets == js.targets
    assert [n for _, n in ts.runs] == [n for _, n in js.runs]
    assert [t.shape for t, _ in ts.runs] == [t.shape for t, _ in js.runs]


def test_error_boxplot_matches_pmpx(tmp_path):
    want, got, jd, td = _both(jerr, terr, tmp_path, times=3,
                              number_sample=60)
    assert set(got) == set(want) == {
        "SP_abs_mean_err", "MP_abs_mean_err", "PMP_abs_mean_err"}
    assert all(np.isfinite(v) for v in got.values())
    _same_files(jd, td, "error_boxplot")
    keys = sorted(want)
    _within_port_spread(
        [want[k] for k in keys],
        _port_spread(terr, tmp_path / "spread",
                     lambda out, _: [out[k] for k in keys], times=3,
                     number_sample=60),
        "error_boxplot abs mean errors")


def test_error_boxplot_wrapper_matches_pmpx(monkeypatch, tmp_path):
    """Both wrappers on the same stand-in samples: the same samplers, step
    counts, burn-in and mean errors; each start state U(-1, 1)."""
    js, ts = _stand_ins(monkeypatch, jerr, terr, "collect")
    kw = dict(times=100, number_sample=20)
    want = jerr.run(out_dir=str(tmp_path / "j"), **kw)
    got = terr.run(out_dir=str(tmp_path / "t"), device="cpu", **kw)
    _same_calls(js, ts)
    assert len(ts.runs) == 3 * kw["times"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=WRAP_RTOL,
                                   atol=WRAP_ATOL)
    for st in (js, ts):  # 300 starts: a KS test against U(-1, 1)
        starts = np.concatenate([t for t, _ in st.runs])
        assert stats.kstest(starts, stats.uniform(-1, 2).cdf).pvalue > 1e-3


def test_banana_matches_pmpx(tmp_path):
    want, got, jd, td = _both(jban, tban, tmp_path, num_steps=400)
    assert set(got) == set(want)
    assert abs(got["PMP_x2_mean"] + 8) < 4.0  # pmpx's bound
    _same_files(jd, td, "banana_samples")


def test_lb_grid_matches_pmpx(tmp_path):
    n = 2000
    want, got, jd, td = _both(jlb, tlb, tmp_path, n_data=n, num_steps=300,
                              steps=(0.1,), method="xla")
    assert set(got) == set(want)
    for algo in ("MH", "MP", "PMP"):
        z = _z([got[f"{algo}_a0.1_beta0"]], n, 50.0 / n)
        assert bool((z < Z_MAX).all()), (algo, z)
    _same_files(jd, td, "lb_grid")


@pytest.mark.parametrize("algos,num_steps", [(("MH", "MP"), 2000),
                                             (("PMP",), 300)])
def test_convergence_matches_pmpx(algos, num_steps, tmp_path):
    """MH and MP need ~1000 supersteps of step 0.02 to reach the posterior
    from (0, 0, 1); PMP's 512 states a superstep, a few dozen."""
    n, temper = 1024, 50.0 / 1024
    want, got, jd, td = _both(jconv, tconv, tmp_path, n_data=n,
                              num_steps=num_steps, temper=temper,
                              method="xla", algos=algos)
    assert set(got) == set(want)
    for algo in algos:
        assert got[f"{algo}_us_per_iter"] > 0
        z = _z([got[f"{algo}_beta0"], got[f"{algo}_beta1"]], n, temper)
        assert bool((z < Z_MAX).all()), (algo, z)
    _same_files(jd, td, "convergence")
    meta = json.loads((td / "convergence.json").read_text())
    assert meta["n_data"] == n and meta["device"] == "cpu"


CORR_KW = dict(dims=(4, 8), Ns=(1, 3), nums=(20, 50), hops=60)


def test_correlation_matches_pmpx(tmp_path):
    want, got, _, _ = _both(jcorr, tcorr, tmp_path, **CORR_KW)
    assert set(got) == set(want)
    rows = []
    for path in (want["csv"], got["csv"]):
        assert os.path.basename(path) == "dimension_chains_parallel.csv"
        with open(path) as f:
            rows.append(list(csv.reader(f)))
    assert rows[1][0] == rows[0][0] == ["dim", "depth", "chain_len", "mean",
                                        "std"]
    assert len(rows[1]) == 1 + 2 * 2 * 2
    assert [r[:3] for r in rows[1]] == [r[:3] for r in rows[0]]
    assert all(np.isfinite(float(v)) for r in rows[1][1:] for v in r[3:])
    # each (dim, depth, chain_len) pooled mean: both chains start at 2.5
    # and share the transient's bias
    _within_port_spread(
        [float(r[3]) for r in rows[0][1:]],
        _port_spread(tcorr, tmp_path / "spread", _pooled_means, **CORR_KW),
        "correlation pooled means")


def _pooled_means(out, _):
    with open(out["csv"]) as f:
        return [float(r[3]) for r in list(csv.reader(f))[1:]]


def test_correlation_wrapper_matches_pmpx(monkeypatch, tmp_path):
    """Both wrappers on the same stand-in samples: the same start states,
    depths and hops, and the same CSV and summary."""
    js, ts = _stand_ins(monkeypatch, jcorr, tcorr, "run_chain")
    want, got, _, _ = _both(jcorr, tcorr, tmp_path, **CORR_KW)
    _same_calls(js, ts)
    assert len(ts.runs) == 2 * 2  # one chain a (dim, N) cell
    for (jt, _), (tt, _) in zip(js.runs, ts.runs):
        assert np.array_equal(tt, jt)
    assert set(got) == set(want)
    for k in want:
        if k != "csv":
            np.testing.assert_allclose(got[k], want[k], rtol=WRAP_RTOL,
                                       atol=WRAP_ATOL)
    rows = [np.loadtxt(o["csv"], delimiter=",", skiprows=1)
            for o in (want, got)]
    np.testing.assert_allclose(rows[1], rows[0], rtol=WRAP_RTOL,
                               atol=WRAP_ATOL)


SKEW_KW = dict(n_data=1024, n_chains=16, num_steps=80, checkpoints=(20, 80),
               method="xla")


def _skew_stats(out, d):
    """Each checkpoint's skewness and across-chain mean of beta0."""
    roots = np.load(d / "skewness.npz")["roots_beta0"]
    c = SKEW_KW["checkpoints"]
    return ([out[f"skewness_at_{k}"] for k in c]
            + [float(roots[:, :k].mean()) for k in c])


def test_skewness_matches_pmpx(tmp_path):
    want, got, jd, td = _both(jskew, tskew, tmp_path, **SKEW_KW)
    assert set(got) == set(want)
    assert all(np.isfinite(v) for v in got.values())
    # pmpx's bound: longer chains no more skewed than the shortest prefix
    assert abs(got["skewness_at_80"]) <= abs(got["skewness_at_20"]) + 0.5
    _same_files(jd, td, "skewness")
    _within_port_spread(
        _skew_stats(want, jd),
        _port_spread(tskew, tmp_path / "spread", _skew_stats, **SKEW_KW),
        "skewness and beta0 means at the checkpoints")


def test_skewness_wrapper_matches_pmpx(monkeypatch, tmp_path):
    """Both wrappers on the same stand-in chains: the same sampler, data
    size, temper, start states and steps, and the same skewness at each
    checkpoint and saved arrays."""
    js, ts = _stand_ins(monkeypatch, jskew, tskew, "run_chains_vmapped",
                        targets=True)
    want, got, jd, td = _both(jskew, tskew, tmp_path, **SKEW_KW)
    _same_calls(js, ts)
    assert len(ts.runs) == 1  # one batch of 16 chains
    assert np.array_equal(ts.runs[0][0], js.runs[0][0])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=WRAP_RTOL,
                                   atol=WRAP_ATOL)
    saved = [np.load(d / "skewness.npz") for d in (jd, td)]
    assert np.array_equal(saved[1]["roots_beta0"], saved[0]["roots_beta0"])
    np.testing.assert_allclose(saved[1]["skew"], saved[0]["skew"],
                               rtol=WRAP_RTOL, atol=WRAP_ATOL)


def test_multichain_matches_pmpx(tmp_path):
    # pmpx shards the 8 chains over its 8 virtual devices; this process is
    # a world of one rank, where the port's sharded=True raises
    # (tests/test_torch_parallel.py runs it over 4 ranks), so the port runs
    # the chains as one batch
    kw = dict(n_data=1024, n_chains=8, num_steps=400, method="xla")
    jd, td = tmp_path / "j", tmp_path / "t"
    want = jmc.run(out_dir=str(jd), sharded=True, **kw)
    got = tmc.run(out_dir=str(td), device="cpu", **kw)
    assert set(got) == set(want)
    # pmpx's bounds: well-mixed chains on an easy posterior
    assert got["rhat_beta0"] < 1.2, got
    assert got["ess_beta0"] > 10
    assert abs(got["mean_beta0"] + 1.0) < 0.15
    _same_files(jd, td, "multichain")


@pytest.mark.parametrize("path", ["fused", "sharded"])
def test_multichain_sweep_matches_pmpx(path, tmp_path):
    """The sweep table's layout beside pmpx's (its default path), on the
    fused farm (the chain kernel's plain version here) and on the
    chain-batched superstep."""
    kw = dict(mode="sweep", ps="4,8", algos="mp", n_chains=4, num_steps=200,
              n_data=512, out_name="farm.json")
    want = jmc.run(out_dir=str(tmp_path / "j"), **kw)
    got = tmc.run(out_dir=str(tmp_path / "t"), path=path, device="cpu", **kw)
    assert set(got) == set(want) and got["path"] == path
    assert "one card" in got["protocol"]
    assert [r["P"] for r in got["rows"]] == [4, 8]
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w)
        assert g["agg_ess_per_s"] > 0 and g["rhat_beta1"] > 0
    saved = json.loads((tmp_path / "t" / "farm.json").read_text())
    assert saved["rows"] == got["rows"]


def test_multichain_sweep_refuses_an_unknown_path(tmp_path):
    with pytest.raises(ValueError, match="fused"):
        tmc.run(mode="sweep", path="fuzed", ps="4", algos="mp", n_chains=2,
                num_steps=10, n_data=64, out_dir=str(tmp_path),
                device="cpu")


def test_cli_runs_the_new_experiments(tmp_path, capsys):
    assert cli.main(["list"]) == 0
    listed = capsys.readouterr().out.split()
    for e in ("error_boxplot", "banana", "lb_grid", "convergence",
              "skewness", "correlation", "multichain"):
        assert e in listed
    assert cli.main(["run", "error_boxplot", "--times", "2",
                     "--number-sample", "40", "--out-dir", str(tmp_path),
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert "PMP_abs_mean_err" in out
