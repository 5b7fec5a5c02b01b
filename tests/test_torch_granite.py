"""granite-4.0-h-micro's hybrid stack as a posterior, on the CPU at a tiny
size: ``GraniteHybridLM`` through ``NNPosterior`` on the generic (vmap)
path and the attached batched path against the benchmark's plain reference
(``benchmark/reference/granite_hybrid.py``) on seeded random weights; the
SSD scan's plain chunked version against the recurrence; the faults and
the control that the cell's check must catch; and the repairs of shared
code the configuration needed (integer inputs, the lazy first state, the
in-place tree positions, the ``nn.density`` span).  The kernels
themselves run in ``tests/test_torch_granite_gpu.py`` (marked gpu)."""

import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness as H  # noqa: E402
from benchmark.reference import checks  # noqa: E402
from benchmark.reference import granite_hybrid as ref  # noqa: E402
from pmpx_torch import profiling  # noqa: E402
from pmpx_torch.kernels import launches, pmp_tree  # noqa: E402
from pmpx_torch.kernels.mamba2_ssd import (  # noqa: E402
    CHUNK, mamba2_ssd, ssd_chunked_ref, ssd_sequential,
)
from pmpx_torch.models import MnistLSTM, MnistMLP  # noqa: E402
from pmpx_torch.models import granite_hybrid as gh  # noqa: E402
from pmpx_torch.targets.nn import NNPosterior, _init_leaf  # noqa: E402

CELL = "granite-h-micro-pmp"
CONFIG = json.loads((ROOT / "benchmark" / "configs"
                     / "granite-4.0-h-micro-pmp8.json").read_text())
# the tiny copy: every published key, the widths cut
TINY = dict(CONFIG, hidden_size=64, num_hidden_layers=3,
            layer_types=["mamba", "attention", "mamba"], vocab_size=97,
            mamba_n_heads=4, mamba_d_head=16, mamba_d_state=8,
            mamba_expand=1, num_attention_heads=4, num_key_value_heads=2,
            shared_intermediate_size=128, sequences=2, seq_len=33,
            dtype="float32")
TINY["params"] = sum(math.prod(s) for _, s, _ in gh.layout(TINY))
LIMITS = json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json")
                    .read_text())
# float32 on both sides, other orders of the same sums (batched products,
# a chunked scan against the recurrence, SDPA against an explicit
# softmax): a few float32 roundings of a loss of ~4.6
TOL = 2e-6


def _inputs(seed=3):
    return {"tokens": ref.make_tokens(seed, TINY, "cpu"),
            "theta0": ref.init_theta(seed + 1, TINY, "cpu")}


def _model():
    return H.load_cell(CELL).module("models", "granite_hybrid")


def _states(theta0, P=4, scale=0.05, seed=0):
    g = torch.Generator().manual_seed(seed)
    return theta0 + scale * torch.randn((P, theta0.numel()), generator=g)


def _rel(a, b):
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def test_layout_is_the_references_and_the_stage_has_772m_parameters():
    assert [x[:2] for x in gh.layout(CONFIG)] == [
        x[:2] for x in ref.layout(CONFIG)]
    assert sum(math.prod(s) for _, s, _ in gh.layout(CONFIG)) == \
        CONFIG["params"] == 772_160_448
    assert gh.layer_kinds(CONFIG) == ["mamba"] * 5 + ["attention"] + [
        "mamba"] * 4


@pytest.mark.parametrize("path", ["vmap", "attached"])
def test_posterior_matches_reference(path):
    inp = _inputs()
    tokens = inp["tokens"]
    post = NNPosterior(gh.GraniteHybridLM(TINY), tokens[:, :-1],
                       tokens[:, 1:].reshape(-1), temper=TINY["temper"],
                       device="cpu")
    if path == "attached":
        gh.attach(post)
    Theta = _states(inp["theta0"])
    got = post.log_prob_batch(Theta)
    want = ref.log_density(Theta, tokens, TINY)
    assert got.shape == (4,) and _rel(got, want) < TOL
    # the four proposals differ, so a shared weight set would show
    assert len(set(want.tolist())) == 4


def test_both_paths_agree_one_proposal_at_a_time():
    inp = _inputs(5)
    tokens = inp["tokens"]
    post = NNPosterior(gh.GraniteHybridLM(TINY), tokens[:, :-1],
                       tokens[:, 1:].reshape(-1), device="cpu")
    Theta = _states(inp["theta0"], P=3, seed=2)
    generic = post.log_prob_batch(Theta)
    gh.attach(post)
    assert _rel(post.log_prob_batch(Theta), generic) < TOL
    assert _rel(post.log_prob(Theta[1]).reshape(1), generic[1:2]) < TOL


@pytest.mark.parametrize("chunk", [1, 3, 7, 11, 16, 33, 64, 256])
def test_ssd_chunked_matches_recurrence(chunk):
    g = torch.Generator().manual_seed(chunk)
    S, T, Hh, hd, N = 3, 33, 4, 16, 8
    x = torch.randn((S, T, Hh, hd), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((S, T, Hh), generator=g))
    A = -torch.exp(torch.randn((S, Hh), generator=g))
    B, C = torch.randn((2, S, T, N), generator=g)
    D = torch.randn((S, Hh), generator=g)
    want = ssd_sequential(x, dt, A, B, C, D)
    before = dict(launches)
    got = ssd_chunked_ref(x, dt, A, B, C, D, chunk)
    # float32: the chunk's closed form against the step-by-step state,
    # sums of up to 33 terms of |y| ~ 30
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    # a CPU tensor takes the chunked sums at CHUNK, counting no launch
    assert torch.equal(mamba2_ssd(x, dt, A, B, C, D),
                       ssd_chunked_ref(x, dt, A, B, C, D, CHUNK))
    assert dict(launches) == before


def _rebased_scan(x, dt, A, B, C, D, rebase=30.0):
    """csrc/mamba2_ssd.cu's arithmetic in torch, float32: R = S / e^c with
    c the log-decay since R's base, a fold of e^(c + a) into R and a new
    base where c + a would pass -rebase."""
    S, T, H, hd = x.shape
    R = torch.zeros((S, H, hd, B.shape[-1]))
    carry = torch.zeros((S, H))
    ys = []
    for t in range(T):
        a = dt[:, t] * A
        nxt = carry + a
        fold = nxt < -rebase
        R = torch.where(fold[..., None, None],
                        R * torch.exp(nxt)[..., None, None], R)
        carry = torch.where(fold, torch.zeros_like(nxt), nxt)
        u = torch.exp(-carry)[..., None] * dt[:, t][..., None] * x[:, t]
        R = R + u[..., None] * B[:, t][:, None, None, :]
        part = torch.einsum("shpn,sn->shp", R, C[:, t])
        ys.append(torch.exp(carry)[..., None] * part
                  + D[..., None] * x[:, t])
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("shift", [-3.0, 0.0, 3.0])
def test_kernels_rebased_state_matches_recurrence(shift):
    """The kernel's state carried over a moving base (folds every few
    positions at shift 3, almost never at -3) is the recurrence's."""
    g = torch.Generator().manual_seed(int(shift) + 10)
    S, T, Hh, hd, N = 2, 150, 4, 8, 16
    x = torch.randn((S, T, Hh, hd), generator=g)
    dt = torch.nn.functional.softplus(
        torch.randn((S, T, Hh), generator=g) + shift)
    A = -torch.exp(torch.rand((S, Hh), generator=g) * 2.7)
    B, C = torch.randn((2, S, T, N), generator=g)
    D = torch.randn((S, Hh), generator=g)
    want = ssd_sequential(x, dt, A, B, C, D)
    got = _rebased_scan(x, dt, A, B, C, D)
    # float32, other orders of the same products and sums (y ~ 10)
    assert float((got - want).abs().max()) < 2e-5 * float(want.abs().max())
    if shift > 0:  # the folds happened
        assert float((dt * A[:, None]).sum(1).min()) < -200.0


def test_ssd_takes_strided_views_and_refuses_bad_shapes():
    g = torch.Generator().manual_seed(0)
    xbc = torch.randn((2, 20, 4 * 16 + 16), generator=g)
    x = xbc[..., :64].reshape(2, 20, 4, 16)
    B, C = xbc[..., 64:72], xbc[..., 72:]
    dt = torch.rand((2, 20, 4), generator=g)
    A, D = -torch.rand((2, 4), generator=g), torch.ones(2, 4)
    assert torch.equal(mamba2_ssd(x, dt, A, B, C, D),
                       mamba2_ssd(x.contiguous(), dt, A, B.contiguous(),
                                  C.contiguous(), D))
    with pytest.raises(ValueError):
        mamba2_ssd(x, dt, A[:1], B, C, D)
    with pytest.raises(TypeError):
        mamba2_ssd(x, dt.double(), A, B, C, D)


def _harness_run(monkeypatch, fault=None, seconds=1.0, seed=2**31 + 9):
    cell = H.load_cell(CELL)
    model = cell.module("models", "granite_hybrid")
    if fault is not None:
        monkeypatch.setattr(
            model, "program_chain",
            lambda c, inp, d: model.faulty_chain(c, inp, d, fault))
    ov = {"config": TINY, "traffic": {"steps_per_launch": 2,
                                      "check_states": 3, "watch": 512}}
    return H.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                      overrides=ov)["result"]


def test_cell_rehearses_on_the_cpu(monkeypatch):
    res = _harness_run(monkeypatch)
    assert res["correct"] and res["failed"] == 0
    assert res["check"]["logp_gap"]["value"] < TOL
    assert res["attempted"] % 2 == 0


# what catches each fault at the tiny size: the forward's faults and half
# the tokens move the log-density, a stuck chain never moves.  A random
# model's loss moves little with its forward (logits of sd ~1/8), so a
# fault's gap varies with the seed: of four seeds, 2**31 + 9 read
# no_decay at 6.2e-6, the others 1.1e-4 to 3.6e-4
CATCHES = {"no_d_skip": "logp_gap", "no_decay": "logp_gap",
           "no_causal_mask": "logp_gap", "half_tokens": "logp_gap",
           "stuck": "stay_share"}


@pytest.mark.parametrize("seed", [5, 77])
@pytest.mark.parametrize("fault", sorted(CATCHES))
def test_each_fault_fails_the_check(monkeypatch, fault, seed):
    assert sorted(CATCHES) == sorted(_model().FAULTS)
    res = _harness_run(monkeypatch, fault, seed=seed)
    name = CATCHES[fault]
    assert not res["correct"]
    assert res["check"][name]["value"] > LIMITS[name]["limit"]


def test_faults_and_control_read_above_the_logp_gap_limit():
    model = _model()
    inp = _inputs(9)
    states = list(_states(inp["theta0"], P=2, scale=1e-4, seed=4))
    gaps = model.logp_gaps(TINY, inp, states, "cpu")
    limit = LIMITS["logp_gap"]["limit"]
    assert gaps["program"] < TOL
    for name in ("no_d_skip", "no_decay", "no_causal_mask", "half_tokens",
                 "control"):
        assert gaps[name] > limit, (name, gaps[name])


def test_control_entry_point_reads_the_control():
    model = _model()
    inp = _inputs(2)
    gen = torch.Generator().manual_seed(1)
    got = model.control(TINY, {}, inp, gen, gen)
    assert got["logp_gap"] > LIMITS["logp_gap"]["limit"]


def test_full_configuration_refuses_the_cpu():
    with pytest.raises(ValueError, match="card"):
        _model().inputs(CONFIG, 1, "cpu")


def test_model_refuses_what_it_does_not_compute():
    for key, value in (("mamba_n_groups", 2), ("mamba_proj_bias", True),
                       ("position_embedding_type", "rope"),
                       ("mamba_expand", 2)):
        with pytest.raises(ValueError):
            gh.GraniteHybridLM(dict(TINY, **{key: value}))
    model = _model()
    with pytest.raises(ValueError):
        model.fault_ops("no_such_fault")
    post = NNPosterior(MnistMLP(), torch.zeros(2, 784), torch.zeros(2),
                       device="cpu")
    with pytest.raises(ValueError):
        gh.attach(post)


def test_tokens_follow_the_zipf_law():
    cfg = dict(TINY, sequences=64, seq_len=511)
    tokens = ref.make_tokens(11, cfg, "cpu")
    assert tokens.shape == (64, 512) and tokens.dtype == torch.int64
    assert int(tokens.min()) >= 0 and int(tokens.max()) < 97
    share = float((tokens == 0).double().mean())
    p0 = 1.0 / sum(1.0 / k for k in range(1, 98))
    # 32,768 draws: the share of id 0 within 5 binomial sds of its law
    assert abs(share - p0) < 5 * math.sqrt(p0 * (1 - p0) / tokens.numel())
    assert torch.equal(tokens, ref.make_tokens(11, cfg, "cpu"))


@pytest.mark.parametrize("side", ["program", "reference"])
def test_first_state_follows_the_stated_law(side):
    cfg = dict(TINY, hidden_size=256, shared_intermediate_size=512,
               mamba_n_heads=8, mamba_d_head=32, mamba_d_state=16)
    if side == "program":
        post = NNPosterior(gh.GraniteHybridLM(cfg), torch.zeros(1, 4).long(),
                           torch.zeros(4).long(), seed=5, device="cpu")
        leaves = post.unravel(post.init_theta())
    else:
        leaves = ref._unravel(ref.init_theta(5, cfg, "cpu"), cfg)
    w = leaves["layers.0.mamba.in_proj.kernel"]
    assert abs(float(w.std()) * 16 - 1) < 0.02  # N(0, 1/256)
    assert abs(float(leaves["embed_tokens.weight"].std()) * 16 - 1) < 0.05
    assert abs(float(leaves["layers.0.mamba.conv1d.kernel"].std()) - 0.5) \
        < 0.05
    assert torch.equal(leaves["layers.1.post_attention_layernorm.weight"],
                       torch.ones(256))
    a = torch.exp(leaves["layers.0.mamba.A_log"])
    assert float(a.min()) >= 1 and float(a.max()) <= 16
    dt = torch.nn.functional.softplus(leaves["layers.2.mamba.dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    assert torch.equal(leaves["layers.0.mamba.D"], torch.ones(8))


def test_integer_inputs_stay_integers_in_bfloat16():
    ids = torch.tensor([[257, 1001, 12543, 5]])
    post = NNPosterior(gh.GraniteHybridLM(dict(TINY, vocab_size=12544)),
                       ids, torch.tensor([1, 2, 3, 4]),
                       compute_dtype=torch.bfloat16, device="cpu")
    assert post.X.dtype == torch.int64 and torch.equal(post.X, ids)
    with post.bound_data(ids + 1):
        assert post.X.dtype == torch.int64 and int(post.X[0, 0]) == 258
    # 257 has no bfloat16 of its own: a float input still rounds
    mlp = NNPosterior(MnistMLP(), torch.full((1, 784), 257.0),
                      torch.zeros(1), compute_dtype=torch.bfloat16,
                      device="cpu")
    assert mlp.X.dtype == torch.bfloat16 and float(mlp.X[0, 0]) == 256.0
    # and the bfloat16 forward runs on the ids
    assert torch.isfinite(post.log_prob_batch(
        post.init_theta()[None])).all()


def _eager_theta0(model, seed):
    """The first state as NNPosterior drew it before the draw was lazy."""
    gen = torch.Generator().manual_seed(seed)
    return torch.cat([_init_leaf(shape, init, gen).reshape(-1)
                      for _, shape, init in model.flax_layout()])


@pytest.mark.parametrize("model_cls", [MnistLSTM, MnistMLP])
def test_lazy_first_state_is_the_eager_one(model_cls):
    model = model_cls()
    post = NNPosterior(model, torch.zeros(2, 784), torch.zeros(2), seed=7,
                       device="cpu")
    assert post._theta0 is None  # nothing drawn at construction
    theta0 = post.init_theta()
    assert torch.equal(theta0, _eager_theta0(model, 7))
    assert post.init_theta() is theta0


@pytest.mark.parametrize("C,depth,d", [(1, 3, 1 << 16), (3, 2, 30_000),
                                       (2, 4, 70_001)])
def test_positions_written_over_the_innovations(C, depth, d):
    g = torch.Generator().manual_seed(d)
    theta = torch.randn((C, d), generator=g)
    eps = torch.randn((C, 1 << depth, d), generator=g)
    want = pmp_tree.tree_positions(theta, eps, depth, 0.02)
    scratch = eps.clone()
    got = pmp_tree.tree_positions(theta, scratch, depth, 0.02,
                                  overwrite=True)
    assert got.data_ptr() == scratch.data_ptr()
    assert torch.equal(got, want)
    # fewer columns than INPLACE_COLUMNS: the innovations stay as they are
    small = eps[:, :, :100].clone()
    out = pmp_tree.tree_positions(theta[:, :100].contiguous(), small, depth,
                                  0.02, overwrite=True)
    assert out.data_ptr() != small.data_ptr()
    assert torch.equal(small, eps[:, :, :100])


def test_density_span_and_kernel_counter():
    inp = _inputs()
    tokens = inp["tokens"]
    post = NNPosterior(gh.GraniteHybridLM(TINY), tokens[:, :-1],
                       tokens[:, 1:].reshape(-1), device="cpu")
    gh.attach(post)
    Theta = _states(inp["theta0"], P=2)
    profiling.reset()
    post.log_prob_batch(Theta)
    assert not [s for s in profiling.spans() if s["name"] == "nn.density"]
    with profiling.recording():
        post.log_prob_batch(Theta)
    found = [s for s in profiling.spans() if s["name"] == "nn.density"]
    assert len(found) == 1
    assert found[0]["attrs"] == {"proposals": 2, "tokens": 66}
    assert found[0]["host_end_us"] >= found[0]["host_start_us"]
    profiling.reset()
    counted = profiling.counters["launches"]
    assert "mamba2_ssd" in counted and counted is launches


def test_chain_over_the_posterior_moves_and_logs_its_density():
    model = _model()
    inp = _inputs(4)
    superstep, theta0 = model.program_chain(TINY, inp, "cpu")
    gen = torch.Generator().manual_seed(3)
    theta, out = superstep(gen, theta0)
    want = ref.log_density([theta], inp["tokens"], TINY)
    assert checks.logp_gap(out["root_logp"].reshape(1), want) < TOL
    assert out["log_accept"].shape == (8,)
