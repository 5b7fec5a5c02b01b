"""The port's native runtime (``pmpx_torch.runtime``), its figures
(``pmpx_torch.experiments.plots``) and the CLI's ``convert`` and ``plot``
against pmpx's: files either package writes read back bit-equal through
the other, natively and through the NumPy fallbacks; the statistics agree
within 1e-6; the resampler follows its weights."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from pmpx import runtime as jrt  # noqa: E402
from pmpx.experiments import convergence as jconv  # noqa: E402
from pmpx.experiments import plots as jplots  # noqa: E402
from pmpx_torch import cli  # noqa: E402
from pmpx_torch import runtime as trt  # noqa: E402
from pmpx_torch.experiments import convergence as tconv  # noqa: E402
from pmpx_torch.experiments import plots as tplots  # noqa: E402
from pmpx_torch.metrics.recorder import save_trace  # noqa: E402

# the chi-square statistic's 0.999 quantile with 3 degrees of freedom
CHI2_3DF_999 = 16.266


@pytest.fixture(scope="module", autouse=True)
def built():
    assert jrt.build(), "pmpx's libpmpx_rt.so failed to build"
    assert trt.build(), "the port's runtime library failed to build"


@pytest.fixture(params=["native", "numpy"])
def port(request, monkeypatch):
    """The port's runtime, natively or with its NumPy fallbacks."""
    if request.param == "numpy":
        monkeypatch.setattr(trt, "_load", lambda: None)
        assert not trt.native_available()
    else:
        assert trt.native_available()
    return trt


def _rows(seed=0, n=257, width=3):
    return np.random.default_rng(seed).normal(size=(n, width)).astype(
        np.float32)


def test_library_builds_into_the_ports_build_dir():
    so = trt.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.parent.parent.name == "pmpx_torch"


def test_traces_cross_between_the_packages(port, tmp_path):
    rows = _rows()
    pj, pt = str(tmp_path / "j.pmpx"), str(tmp_path / "t.pmpx")
    wj, wt = jrt.TraceWriter(pj, 3), port.TraceWriter(pt, 3)
    for r in rows:
        wj.append(r)
        wt.append(r)
    assert wj.close() == wt.close() == len(rows)
    for path in (pj, pt):
        np.testing.assert_array_equal(port.read_trace(path), rows)
        np.testing.assert_array_equal(jrt.read_trace(path), rows)
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    with pytest.raises(ValueError):
        port.TraceWriter(str(tmp_path / "w.pmpx"), 3).append(np.zeros(2))


def test_read_trace_drops_a_partial_row_and_refuses_others(port, tmp_path):
    rows = _rows(1, 5, 4)
    p = str(tmp_path / "t.pmpx")
    w = port.TraceWriter(p, 4)
    for r in rows:
        w.append(r)
    assert w.flush() == 5
    w.close()
    with open(p, "ab") as f:
        f.write(np.float32(7.0).tobytes())  # a crash mid-row
    np.testing.assert_array_equal(port.read_trace(p), rows)
    np.testing.assert_array_equal(jrt.read_trace(p), rows)
    bad = tmp_path / "bad.pmpx"
    bad.write_bytes(b"NOPE" + bytes(12))
    with pytest.raises(IOError):
        port.read_trace(str(bad))


def test_read_floats_matches_pmpx(port, tmp_path):
    data = np.random.default_rng(2).normal(size=5000).astype(np.float32)
    p = tmp_path / "data_x.txt"
    # the reference's format: space-separated floats on one line, with
    # the native parser's tolerance of commas and newlines
    p.write_text(" ".join(f"{v:.9g}" for v in data[:2500]) + ",\n"
                 + ", ".join(f"{v:.9g}" for v in data[2500:]))
    got = port.read_floats(str(p))
    np.testing.assert_array_equal(got, jrt.read_floats(str(p)))
    np.testing.assert_array_equal(got, data)  # 9 digits round-trip f32


def test_statistics_match_pmpx(port):
    """autocov and mean_std within 1e-6 of pmpx's native ones."""
    x = np.random.default_rng(3).normal(2.0, 3.0, size=4000)
    np.testing.assert_allclose(port.autocov(x, 50), jrt.autocov(x, 50),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port.mean_std(x), jrt.mean_std(x),
                               rtol=1e-6, atol=1e-6)


def test_discrete_sample_follows_its_weights(port):
    w = np.array([1.0, 2.0, 3.0, 4.0])
    n = 40_000
    draws = port.discrete_sample(w, n, seed=7)
    assert draws.dtype == np.int32 and draws.shape == (n,)
    expected = n * w / w.sum()
    chi2 = (((np.bincount(draws, minlength=4) - expected) ** 2)
            / expected).sum()
    assert chi2 < CHI2_3DF_999, chi2
    np.testing.assert_array_equal(port.discrete_sample(w, 100, seed=7),
                                  draws[:100])


def test_load_reference_data_matches_pmpx(port, tmp_path):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, 300).astype(np.float32)
    y = (-1 + 2 * x + 0.5 * rng.normal(size=300)).astype(np.float32)
    for name, a in (("data_x.txt", x), ("data_y.txt", y)):
        (tmp_path / name).write_text(" ".join(f"{v:.9g}" for v in a))
    jx, jy = jconv.load_reference_data(str(tmp_path))
    tx, ty = tconv.load_reference_data(str(tmp_path), device="cpu")
    assert tx.dtype == torch.float32 and tx.device.type == "cpu"
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    (tmp_path / "data_y.txt").write_text("1 2")
    with pytest.raises(ValueError, match="bad reference dataset"):
        tconv.load_reference_data(str(tmp_path), device="cpu")


def test_figures_have_pmpx_names(tmp_path):
    """render_convergence and render_ess_msjd write the files pmpx's write
    from the same inputs."""
    rng = np.random.default_rng(5)
    arrays = {}
    for algo in ("MH", "PMP"):
        arrays[f"{algo}_params"] = rng.normal(size=(40, 3))
        arrays[f"{algo}_time"] = np.linspace(0.01, 0.4, 40)
    npz = save_trace(str(tmp_path), "convergence", arrays)
    summary = tmp_path / "summary.json"
    summary.write_text(json.dumps({
        "mp_P8_ess_per_s": 1.0, "pmp_P8_msjd_per_s": 2.0,
        "pmp_P8_all_ess_per_s": 3.0, "mp_P32_ess_per_s": 4.0}))
    for pkg, tag in ((jplots, "j"), (tplots, "t")):
        assert pkg.render_convergence(npz, str(tmp_path / tag))
        assert pkg.render_ess_msjd(str(summary), str(tmp_path / tag))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j")) == [
        "conv_iter_and_time.pdf", "ess_compare.pdf", "msjd_compare.pdf"]


def test_cli_convert_and_plot(tmp_path, capsys, monkeypatch):
    rows = _rows(6, 20, 2)
    p = str(tmp_path / "trace.pmpx")
    w = jrt.TraceWriter(p, 2)
    for r in rows:
        w.append(r)
    w.close()
    assert cli.main(["convert", p]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"out": str(tmp_path / "trace.npy"), "shape": [20, 2]}
    np.testing.assert_array_equal(np.load(out["out"]), rows)
    npz = save_trace(str(tmp_path), "run", {
        "loss": np.linspace(3, 1, 30), "train_acc": np.linspace(0, 1, 30),
        "test_acc": np.linspace(0, 0.9, 30)})
    pdf = str(tmp_path / "fig.pdf")
    assert cli.main(["plot", npz, "--out", pdf]) == 0
    assert json.loads(capsys.readouterr().out) == {"out": pdf}
    assert os.path.getsize(pdf) > 0
    assert cli.main(["plot", npz]) == 0
    assert (tmp_path / "run.pdf").exists()
    monkeypatch.setattr(cli, "maybe_plot", lambda fn: None)  # no matplotlib
    with pytest.raises(SystemExit, match="needs matplotlib"):
        cli.main(["plot", npz])
