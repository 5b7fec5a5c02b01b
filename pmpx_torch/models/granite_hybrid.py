"""granite-4.0-h-micro's hybrid Mamba-2/attention language model, as a
posterior over its weights.

The published model (``granitemoehybrid``,
https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json)
is 40 layers of hidden 2,048: Mamba-2 mixers, with a GQA attention layer
at every tenth (indices 5, 15, 25, 35), and a SwiGLU ``shared_mlp`` in
every layer.  :class:`GraniteHybridLM` builds the first
``num_hidden_layers`` of ``layer_types`` from a config dict of the
published keys, so a pipeline stage at the published widths and a tiny
copy for the CPU tests are one class.  Each layer is

    h = h + residual_multiplier * mixer(rmsnorm(h))
    h = h + residual_multiplier * mlp(rmsnorm(h))

* Mamba-2 mixer: ``in_proj`` to [z | xBC | dt] (d_inner, d_inner + 2
  d_state, heads); a causal depthwise conv of width ``mamba_d_conv`` with
  bias over xBC, then SiLU, split to [x | B | C]; dt = softplus(dt +
  dt_bias), A = -exp(A_log); the SSD scan per head
  (:func:`pmpx_torch.kernels.mamba2_ssd.mamba2_ssd`, the D skip
  included, the state 0 at each sequence's start); the gated RMSNorm
  ``norm(y * silu(z))`` over all d_inner channels (one group); ``out_proj``.
* attention: causal GQA with ``num_attention_heads`` query and
  ``num_key_value_heads`` KV heads of hidden / heads, no position
  encoding (``nope``), softmax scale ``attention_multiplier``.
* MLP: ``output_linear(silu(g) * u)``, [g | u] = ``input_linear(h)``.
* The embedding times ``embedding_multiplier``; a final RMSNorm; the
  tied head; logits / ``logits_scaling``.

The weights come from the chain's state: ``flax_layout()`` lists (path,
shape, initialiser) of every leaf in theta's order (the embedding, the
layers in order, the final norm), each kernel (in, out) as ``x @ W``
takes it.  The module holds no weights of its own (each leaf is an empty
placeholder that ``NNPosterior``'s ``functional_call`` replaces), so a
stage of 772 M parameters costs nothing to build.

Precision.  The leaves are taken in the posterior's compute dtype (the
published bfloat16 on the card); each product, and the conv, takes its
operands in that dtype, sums in float32 and gives that dtype, as does the
MLP's gate silu(g) * u; the residual stream, the norms, the Mamba gate
y * silu(z), the scan's state and the loss are float32.  :func:`forward` is
written once for both ways the posterior evaluates it: under
``torch.func.vmap`` over proposals (the generic path, ``NNPosterior``'s
``functional_call``), and with the proposal axis explicit (:func:`attach`:
all P proposals in one pass, each product a batched product with P
distinct weight sets).  The products, the scan and the attention go
through an :class:`Ops`, so a check can run the same forward with one of
them altered.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from pmpx_torch.kernels.mamba2_ssd import mamba2_ssd

__all__ = ["GraniteHybridLM", "Ops", "OPS", "layout", "layer_kinds",
           "forward", "head_logits", "causal_attention",
           "make_fast_log_prob_batch", "attach"]


def causal_attention(q, k, v, scale: float, causal: bool = True):
    """softmax(q k^T * scale + causal mask) v over (S, heads, T, hd), the
    KV heads already repeated to the query heads."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          scale=scale)


class Ops(NamedTuple):
    """What :func:`forward` computes with: ``mm(a, b)`` each product,
    ``ssd(x, dt, A, B, C, D)`` the scan, ``attention(q, k, v,
    scale)``."""

    mm: Callable = torch.matmul
    ssd: Callable = mamba2_ssd
    attention: Callable = causal_attention


OPS = Ops()


def _sizes(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    nh, hd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    N = cfg["mamba_d_state"]
    di = nh * hd
    if cfg["mamba_n_groups"] != 1:
        raise ValueError("the mixer takes one group of B and C "
                         f"(mamba_n_groups 1), not {cfg['mamba_n_groups']}")
    if di != cfg["mamba_expand"] * H:
        raise ValueError(f"mamba_n_heads * mamba_d_head = {di} is not "
                         f"mamba_expand * hidden_size = "
                         f"{cfg['mamba_expand'] * H}")
    for key, want in (("mamba_proj_bias", False), ("attention_bias", False),
                      ("tie_word_embeddings", True),
                      ("position_embedding_type", "nope"),
                      ("mamba_conv_bias", True)):
        if cfg.get(key, want) != want:
            raise ValueError(f"{key} must be {want!r}, got {cfg[key]!r}")
    nq, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    if H % nq or nq % nkv:
        raise ValueError(f"{nq} query heads over {nkv} KV heads do not "
                         f"divide hidden {H}")
    return {"H": H, "nh": nh, "hd": hd, "N": N, "di": di,
            "conv": di + 2 * N, "K": cfg["mamba_d_conv"], "nq": nq,
            "nkv": nkv, "ahd": H // nq, "I": cfg["shared_intermediate_size"],
            "V": cfg["vocab_size"]}


def layer_kinds(cfg: dict) -> list:
    """The kinds of the layers held: the first ``num_hidden_layers`` of
    the published ``layer_types``."""
    kinds = list(cfg["layer_types"][:cfg["num_hidden_layers"]])
    if len(kinds) != cfg["num_hidden_layers"] or not set(kinds) <= {
            "mamba", "attention"}:
        raise ValueError(f"layer_types {kinds} for {cfg['num_hidden_layers']}"
                         " layers of mamba or attention")
    return kinds


def layout(cfg: dict) -> list:
    """(path, shape, initialiser) of every leaf, in theta's order.
    Kernels N(0, 1/fan_in) (``normal``), the embedding N(0, 1/hidden) as
    the tied head's kernel, the conv's taps and bias N(0, 1/d_conv), norm
    weights and D 1, A_log and dt_bias Mamba-2's own initialisers."""
    s = _sizes(cfg)
    H = s["H"]
    out = [("embed_tokens.weight", (s["V"], H), f"normal:{H ** -0.5!r}")]
    for i, kind in enumerate(layer_kinds(cfg)):
        pre = f"layers.{i}."
        out.append((pre + "input_layernorm.weight", (H,), "ones"))
        if kind == "mamba":
            m = pre + "mamba."
            out += [
                (m + "in_proj.kernel", (H, s["di"] + s["conv"] + s["nh"]),
                 "normal"),
                (m + "conv1d.kernel", (s["K"], s["conv"]), "normal"),
                (m + "conv1d.bias", (s["conv"],),
                 f"normal:{s['K'] ** -0.5!r}"),
                (m + "dt_bias", (s["nh"],), "mamba_dt_bias"),
                (m + "A_log", (s["nh"],), "mamba_A_log"),
                (m + "D", (s["nh"],), "ones"),
                (m + "norm.weight", (s["di"],), "ones"),
                (m + "out_proj.kernel", (s["di"], H), "normal"),
            ]
        else:
            a = pre + "self_attn."
            kv = s["nkv"] * s["ahd"]
            out += [(a + "q_proj.kernel", (H, s["nq"] * s["ahd"]), "normal"),
                    (a + "k_proj.kernel", (H, kv), "normal"),
                    (a + "v_proj.kernel", (H, kv), "normal"),
                    (a + "o_proj.kernel", (s["nq"] * s["ahd"], H), "normal")]
        out += [(pre + "post_attention_layernorm.weight", (H,), "ones"),
                (pre + "shared_mlp.input_linear.kernel", (H, 2 * s["I"]),
                 "normal"),
                (pre + "shared_mlp.output_linear.kernel", (s["I"], H),
                 "normal")]
    out.append(("norm.weight", (H,), "ones"))
    return out


def _b(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``w`` (*lead, C) viewed to broadcast over ``like`` (*lead, ..., C)."""
    extra = like.dim() - w.dim()
    return w.reshape(*w.shape[:-1], *(1,) * extra, w.shape[-1])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (..., C) float32 over its last axis, times the weight."""
    return F.rms_norm(x, x.shape[-1:], eps=eps) * _b(w.float(), x)


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv of x (*lead, B, T, C) with taps w
    (*lead, K, C) and bias b (*lead, C): out[t] = b + sum_k w[k] x[t - K
    + 1 + k], zeros before the start; one grouped ``conv1d`` over every
    proposal's channels (sums in float32), in x's type."""
    lead, (K, C) = w.shape[:-2], w.shape[-2:]
    Bn, T = x.shape[-3], x.shape[-2]
    n = len(lead)
    xt = x.movedim(-1, -2).movedim(n, 0).reshape(Bn, -1, T)
    wt = w.movedim(-1, -2).reshape(-1, 1, K).to(x.dtype)
    out = F.conv1d(xt, wt, b.reshape(-1).to(x.dtype), padding=K - 1,
                   groups=wt.shape[0])[..., :T]
    out = F.silu(out, inplace=True)
    return out.reshape(Bn, *lead, C, T).movedim(0, n).movedim(-1, -2)


def _mamba(x, get, pre, cfg, s, B, T, ops, cd):
    lead = x.shape[:-2]
    S = math.prod(lead) * B
    di, N, nh, hd = s["di"], s["N"], s["nh"], s["hd"]
    zxbcdt = ops.mm(x.to(cd), get(pre + "in_proj.kernel"))
    zxbcdt = zxbcdt.reshape(*lead, B, T, zxbcdt.shape[-1])
    z, xbc = zxbcdt[..., :di], zxbcdt[..., di:di + s["conv"]]
    dt = zxbcdt[..., di + s["conv"]:]
    xbc = causal_conv_silu(xbc, get(pre + "conv1d.kernel"),
                           get(pre + "conv1d.bias")).contiguous()
    dt = F.softplus(dt.float() + _b(get(pre + "dt_bias").float(), dt))
    A = -torch.exp(get(pre + "A_log").float())
    D = get(pre + "D").float()
    per_seq = [t[..., None, :].expand(*lead, B, nh).reshape(S, nh)
               for t in (A, D)]
    y = ops.ssd(xbc[..., :di].reshape(S, T, nh, hd), dt.reshape(S, T, nh),
                per_seq[0], xbc[..., di:di + N].reshape(S, T, N),
                xbc[..., di + N:].reshape(S, T, N), per_seq[1])
    g = F.silu(z.reshape(*lead, B * T, di).float(), inplace=True)
    g = g.mul_(y.reshape(*lead, B * T, di))
    g = rmsnorm(g, get(pre + "norm.weight"), cfg["rms_norm_eps"])
    return ops.mm(g.to(cd), get(pre + "out_proj.kernel"))


def _attention(x, get, pre, cfg, s, B, T, ops, cd):
    lead = x.shape[:-2]
    nq, nkv, ahd = s["nq"], s["nkv"], s["ahd"]
    xc = x.to(cd)

    def heads(name, n):
        t = ops.mm(xc, get(pre + name)).reshape(*lead, B, T, n, ahd)
        return t.transpose(-2, -3).reshape(-1, n, T, ahd)

    q = heads("q_proj.kernel", nq)
    k = heads("k_proj.kernel", nkv).repeat_interleave(nq // nkv, dim=1)
    v = heads("v_proj.kernel", nkv).repeat_interleave(nq // nkv, dim=1)
    o = ops.attention(q, k, v, cfg["attention_multiplier"])
    o = o.reshape(*lead, B, nq, T, ahd).transpose(-2, -3)
    return ops.mm(o.reshape(*lead, B * T, nq * ahd), get(pre + "o_proj.kernel"))


def _mlp(x, get, pre, ops, cd):
    gu = ops.mm(x.to(cd), get(pre + "shared_mlp.input_linear.kernel"))
    g, u = gu.chunk(2, dim=-1)
    return ops.mm(F.silu(g) * u, get(pre + "shared_mlp.output_linear.kernel"))


def forward(get: Callable, ids: torch.Tensor, cfg: dict,
            ops: Ops = OPS) -> torch.Tensor:
    """The final normed hidden states (*lead, B * T, hidden) float32 of
    the token ids (B, T); ``get(path)`` gives a leaf in the compute dtype,
    (*lead, *shape): lead () under ``vmap``, (P,) with the proposal axis
    explicit."""
    s = _sizes(cfg)
    B, T = ids.shape
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    E = get("embed_tokens.weight")
    cd = E.dtype
    h = E.index_select(-2, ids.reshape(-1)).float() * cfg[
        "embedding_multiplier"]
    del E
    for i, kind in enumerate(layer_kinds(cfg)):
        pre = f"layers.{i}."
        x = rmsnorm(h, get(pre + "input_layernorm.weight"), eps)
        mixer = _mamba if kind == "mamba" else _attention
        sub = pre + ("mamba." if kind == "mamba" else "self_attn.")
        h = torch.add(h, mixer(x, get, sub, cfg, s, B, T, ops, cd), alpha=rm)
        x = rmsnorm(h, get(pre + "post_attention_layernorm.weight"), eps)
        h = torch.add(h, _mlp(x, get, pre, ops, cd), alpha=rm)
    return rmsnorm(h, get("norm.weight"), eps)


def head_logits(hn: torch.Tensor, E: torch.Tensor, cfg: dict,
                ops: Ops = OPS) -> torch.Tensor:
    """Logits (..., B * T, vocab) float32 of the tied head: hn (..., B * T,
    hidden) against the embedding E (..., vocab, hidden), over
    ``logits_scaling``."""
    return ops.mm(hn.to(E.dtype), E.transpose(-1, -2)).float() / cfg[
        "logits_scaling"]


def _leaf(module: nn.Module, path: str):
    return functools.reduce(getattr, path.split("."), module)


class GraniteHybridLM(nn.Module):
    """The stage of ``config["num_hidden_layers"]`` layers (see the
    module's docstring).  ``forward(ids)`` takes token ids (B, T) and
    returns the logits (B * T, vocab) float32 of the next token at each
    position; the weights come through ``functional_call``."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = dict(config)
        self._layout = layout(self.config)
        for path, _, _ in self._layout:
            *mods, leaf = path.split(".")
            mod = self
            for name in mods:
                if not hasattr(mod, name):
                    mod.add_module(name, nn.Module())
                mod = getattr(mod, name)
            mod.register_parameter(leaf, nn.Parameter(torch.empty(0)))

    def flax_layout(self) -> list:
        return list(self._layout)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        get = functools.partial(_leaf, self)
        return head_logits(forward(get, ids, self.config),
                           get("embed_tokens.weight"), self.config)


def make_fast_log_prob_batch(posterior, ops: Ops = OPS):
    """A ``log_prob_batch(Theta)`` for an NNPosterior over
    :class:`GraniteHybridLM`: all P rows of Theta (P, d) in one pass with
    the proposal axis explicit, Theta cast to the posterior's
    ``compute_dtype`` in one pass (each leaf a view of the cast), the scan
    through ``ops.ssd`` (the kernel on a card), the head and the
    cross-entropy one proposal at a time (the logits of all eight would
    take 6.6 GB), in float32."""
    cfg = posterior.model.config
    cd = posterior.compute_dtype or torch.float32

    def fast(Theta: torch.Tensor) -> torch.Tensor:
        get = posterior.unravel(Theta.to(cd)).__getitem__
        hn = forward(get, posterior.X, cfg, ops)
        E = get("embed_tokens.weight")
        ce = [F.cross_entropy(head_logits(hn[p], E[p], cfg, ops),
                              posterior.Y) for p in range(Theta.shape[0])]
        return -posterior.temper * torch.stack(ce)

    return fast


def attach(posterior, ops: Ops = OPS) -> None:
    """Install the batched density on an NNPosterior over
    :class:`GraniteHybridLM` (``log_prob_batch`` and ``log_prob`` go
    through it; the same math as the generic path).  Raises ValueError for
    a posterior over another model, or a stochastic one."""
    if not isinstance(getattr(posterior, "model", None), GraniteHybridLM):
        raise ValueError("attach() requires an NNPosterior over "
                         "pmpx_torch.models.GraniteHybridLM")
    if posterior.stochastic:
        raise ValueError("the granite posterior is deterministic")
    posterior._fast_batch = make_fast_log_prob_batch(posterior, ops)
