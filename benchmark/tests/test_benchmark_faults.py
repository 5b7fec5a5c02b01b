"""A run whose timed path is broken underneath comes out not correct: for
each fault a cell can have, the rest of the run (window, outputs, check)
as the harness drives it, on the CPU through the plain versions.

* ``stuck``: a superstep returns its state unchanged;
* ``half``: half the data left out, the mean taken over the rest (the
  program sees the first half twice);
* ``altered``: an answer altered where it is produced (a root's b0, or the
  log-density a superstep reports);
* ``walk``: the LSTM cell's selection altered where it is produced (each
  superstep's slot drawn uniformly, the weights ignored).

No cell crosses chips, so none can leave out an exchange between them.
The tests marked ``gpu`` read the faults that the linreg cells' draws and
the LSTM's selection alone must show at the cells' own sizes, and print
each reading."""

import json

import pytest
import torch

from benchmark import harness as H
from benchmark.tests import tiny

RUN_SECONDS = json.loads((H.ROOT / "BENCHMARK.json").read_text())[
    "run_seconds"]

# the one-chain and farm cells judge the law of the draws alone: half the
# data shifts the posterior by about sqrt(temper) posterior sds, here 2,
# which some hundreds of effective draws show
FUSED = {"config": dict(tiny.LINREG["config"], n_data=100, temper=4.0),
         "traffic": dict(tiny.LINREG["traffic"], chunk=1000,
                         burn_in_launches=1)}
CASES = [(cell, fault) for cell in ("linreg-p1024-fused",
                                    "linreg-p1024-farm132",
                                    "linreg-p1024-sweep", "mnist-lstm-pmp")
         for fault in ("stuck", "half", "altered")]
CASES.append(("mnist-lstm-pmp", "walk"))
# the uniform walk shows in select_z as the square root of the supersteps:
# some hundreds of them
WALK = {"config": tiny.LSTM["config"],
        "traffic": dict(tiny.LSTM["traffic"], steps_per_launch=16)}
# at the cells' sizes: the faults only the law of the draws or of the
# selection can show, each on seeds of its own
CARD_CASES = ([("linreg-p1024-fused", "half", s)
               for s in (3, 2**31 + 17, 987654323, 12345, 2**32 + 7, 555)]
              + [("linreg-p1024-farm132", "half", s)
                 for s in (3, 2**31 + 17, 987654323)]
              + [("mnist-lstm-pmp", "walk", s)
                 for s in (3, 2**31 + 17, 987654323)])


def _half(t):
    h = t.shape[0] // 2
    return torch.cat([t[:h], t[:h], t[2 * h:]])


def _patch(monkeypatch, cell, fault):
    from pmpx_torch.kernels import fused_chain as fc
    from pmpx_torch.samplers import pmp

    model = cell.module("models", cell.config["model"])
    if fault == "walk":
        real_cat = pmp.categorical
        monkeypatch.setattr(
            pmp, "categorical",
            lambda logits, generator=None, u=None: real_cat(
                torch.zeros_like(logits), generator=generator, u=u))
        return
    if fault == "half":
        linreg = cell.config["model"] == "linreg"
        keys = ("x", "y") if linreg else ("X", "Y")
        name = "program_target" if linreg else "program_chain"
        real = getattr(model, name)
        monkeypatch.setattr(
            model, name,
            lambda c, inp, d: real(
                c, dict(inp, **{k: _half(inp[k]) for k in keys}), d))
        return
    if cell.traffic["path"] != "compiled_chain":
        real_chunk = fc.chain_chunk

        def chunk(xg, yg, theta, **kw):
            tr, th = real_chunk(xg, yg, theta, **kw)
            if fault == "stuck":
                tr = tr.clone()
                tr[..., :3, :] = theta[..., :, None]
                return tr, theta.clone()
            tr = tr.clone()
            tr[..., 0, :] += 0.5
            return tr, th

        monkeypatch.setattr(fc, "chain_chunk", chunk)
        return
    real_chain = model.program_chain

    def program_chain(c, inp, d):
        step, theta0 = real_chain(c, inp, d)

        def broken(gen, theta):
            new, out = step(gen, theta)
            if fault == "stuck":
                return theta, out
            return new, dict(out, root_logp=out["root_logp"] * 1.01)

        return broken, theta0

    monkeypatch.setattr(model, "program_chain", program_chain)


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(monkeypatch, name, fault):
    cell = H.load_cell(name)
    ov = tiny.overrides(name)
    if cell.traffic["path"] != "compiled_chain":
        ov = FUSED
    if fault == "walk":
        ov = WALK
    _patch(monkeypatch, cell, fault)
    out = H.run_cell(cell, 2**31 + 5, 4.0 if fault == "walk" else 2.0,
                     False, torch.device("cpu"), overrides=ov)
    assert not out["result"]["correct"], out["result"]["check"]


@pytest.mark.parametrize("name", ["linreg-p1024-fused", "mnist-lstm-pmp"])
def test_sound_run_at_fault_sizes_is_correct(name):
    cell = H.load_cell(name)
    ov = FUSED if "fused" in name else WALK
    out = H.run_cell(cell, 2**31 + 5, 2.0, False, torch.device("cpu"),
                     overrides=ov)
    assert out["result"]["correct"], out["result"]["check"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,fault,seed", CARD_CASES)
def test_fault_is_not_correct_at_the_cells_size(cuda, monkeypatch, name,
                                                fault, seed):
    cell = H.load_cell(name)
    _patch(monkeypatch, cell, fault)
    out = H.run_cell(cell, seed, RUN_SECONDS, False, cuda)
    check = out["result"]["check"]
    print(json.dumps({"workload": name, "fault": fault, "seed": seed,
                      "check": check}), flush=True)
    assert not out["result"]["correct"], check
