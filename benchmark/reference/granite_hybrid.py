"""Plain reference of the granite-4.0-h-micro posterior configuration.

Independent of the program: it imports nothing of ``pmpx_torch`` and takes
nothing the program made.  It holds

* the tokens' law (:func:`make_tokens`): ``sequences`` rows of
  ``seq_len + 1`` ids, i.i.d. Zipf with exponent ``assumed.zipf`` over the
  vocabulary slice (p(k) proportional to 1/(k+1)^s), drawn on the device
  from the run's seed by the inverse of the law's CDF;
* the chain's first state (:func:`init_theta`), leaf by leaf in
  :func:`layout`'s order: kernels N(0, 1/fan_in), the embedding N(0,
  1/hidden), the conv's taps and bias N(0, 1/d_conv), norm weights and D
  1, A_log = log U(1, 16), dt_bias = softplus^-1(dt) with dt log-uniform
  on [1e-3, 1e-1];
* the log-density (:func:`log_density`): log pi(theta) = -temper * mean
  cross-entropy of each next token over every position of every
  sequence, through the stage's layers (granitemoehybrid's equations:
  h += residual_multiplier * mixer(rmsnorm(h)), h += residual_multiplier *
  mlp(rmsnorm(h)); the Mamba-2 mixer's in_proj to [z | xBC | dt], causal
  depthwise conv with bias and SiLU, dt = softplus(dt + dt_bias), A =
  -exp(A_log), the recurrence S_t = exp(dt_t A) S_{t-1} + dt_t x_t (outer)
  B_t, y_t = S_t C_t + D x_t one position at a time from S_0 = 0, the
  gated RMSNorm of y * silu(z), out_proj; attention as explicit softmax(q
  k^T * attention_multiplier + causal mask) v with the KV heads repeated
  to the query heads, no position encoding; the SwiGLU MLP silu(g) * u of
  [g | u]; the embedding times embedding_multiplier, a final RMSNorm, the
  tied head over logits_scaling), in float32 with TF32 off, one state at a
  time, the scan over all sequences at once and the attention one
  sequence at a time.  The weights are the state rounded to the
  configuration's ``dtype``, as the published model stores them
  (bfloat16); every operation on them is float32.  So the gap to the
  program is its arithmetic's, not the storage's (at bfloat16 the
  storage's rounding alone moves the loss as much as the program's
  arithmetic does).

Departures from the published model: the weights are random (drawn as
above) and each kernel is stored (in, out), as ``x @ W`` takes it; the
stage holds the first ``num_hidden_layers`` of ``layer_types`` and the
vocabulary slice of ``vocab_size`` ids, which the tokens, the logits and
the loss are over (the published model's other layers and vocabulary rows
lie on other chips of the stated deployment); the arithmetic is float32
where the published model's runs in bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["layout", "make_tokens", "init_theta", "log_density"]


def _kinds(config: dict) -> list:
    return list(config["layer_types"][:config["num_hidden_layers"]])


def layout(config: dict) -> list:
    """(path, shape, law) of every leaf, in theta's order: the embedding,
    each layer's norms, mixer and MLP, the final norm."""
    H, V = config["hidden_size"], config["vocab_size"]
    nh, hd = config["mamba_n_heads"], config["mamba_d_head"]
    N, K = config["mamba_d_state"], config["mamba_d_conv"]
    di, conv = nh * hd, nh * hd + 2 * N
    nq, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    ahd, inter = H // nq, config["shared_intermediate_size"]
    out = [("embed_tokens.weight", (V, H), ("normal", H))]
    for i, kind in enumerate(_kinds(config)):
        pre = f"layers.{i}."
        out.append((pre + "input_layernorm.weight", (H,), ("ones",)))
        if kind == "mamba":
            m = pre + "mamba."
            out += [(m + "in_proj.kernel", (H, di + conv + nh), ("normal", H)),
                    (m + "conv1d.kernel", (K, conv), ("normal", K)),
                    (m + "conv1d.bias", (conv,), ("normal", K)),
                    (m + "dt_bias", (nh,), ("dt_bias",)),
                    (m + "A_log", (nh,), ("A_log",)),
                    (m + "D", (nh,), ("ones",)),
                    (m + "norm.weight", (di,), ("ones",)),
                    (m + "out_proj.kernel", (di, H), ("normal", di))]
        else:
            a = pre + "self_attn."
            out += [(a + "q_proj.kernel", (H, nq * ahd), ("normal", H)),
                    (a + "k_proj.kernel", (H, nkv * ahd), ("normal", H)),
                    (a + "v_proj.kernel", (H, nkv * ahd), ("normal", H)),
                    (a + "o_proj.kernel", (nq * ahd, H), ("normal", nq * ahd))]
        out += [(pre + "post_attention_layernorm.weight", (H,), ("ones",)),
                (pre + "shared_mlp.input_linear.kernel", (H, 2 * inter),
                 ("normal", H)),
                (pre + "shared_mlp.output_linear.kernel", (inter, H),
                 ("normal", inter))]
    out.append(("norm.weight", (H,), ("ones",)))
    return out


def make_tokens(seed: int, config: dict, device) -> torch.Tensor:
    """Token ids (sequences, seq_len + 1) int64 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    V = config["vocab_size"]
    s = config["assumed"]["zipf"]
    p = torch.arange(1, V + 1, dtype=torch.float64, device=device) ** -s
    cdf = torch.cumsum(p / p.sum(), 0)
    u = torch.rand((config["sequences"], config["seq_len"] + 1),
                   generator=gen, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp(max=V - 1)


def init_theta(seed: int, config: dict, device) -> torch.Tensor:
    """The first state (d,) float32 on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = []
    for _, shape, law in layout(config):
        n = math.prod(shape)
        if law[0] == "normal":
            leaf = torch.randn(n, generator=gen, device=device) / law[1] ** 0.5
        elif law[0] == "ones":
            leaf = torch.ones(n, device=device)
        else:
            u = torch.rand(n, generator=gen, device=device)
            if law[0] == "A_log":
                leaf = torch.log(1.0 + 15.0 * u)
            else:
                dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                                     - math.log(1e-3)))
                leaf = dt + torch.log(-torch.expm1(-dt))
        leaves.append(leaf)
    return torch.cat(leaves)


def _unravel(theta: torch.Tensor, config: dict) -> dict:
    out, off = {}, 0
    for path, shape, _ in layout(config):
        n = math.prod(shape)
        out[path] = theta[off:off + n].reshape(shape)
        off += n
    return out


def log_density(theta: torch.Tensor, tokens: torch.Tensor,
                config: dict) -> torch.Tensor:
    """log pi of each state of ``theta`` (m, d), float32 on the tokens'
    device."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            dtype = getattr(torch, config["dtype"])
            out = [_one(t.to(tokens.device, dtype).float(), tokens, config)
                   for t in theta]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return torch.stack(out)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _mamba(x, p, m, config):
    Bn, T, _ = x.shape
    nh, hd = config["mamba_n_heads"], config["mamba_d_head"]
    N, K = config["mamba_d_state"], config["mamba_d_conv"]
    di = nh * hd
    zxbcdt = x @ p[m + "in_proj.kernel"]
    z, xbc, dt = zxbcdt.split([di, di + 2 * N, nh], dim=-1)
    w = p[m + "conv1d.kernel"]  # (K, channels): tap k multiplies x[t-K+1+k]
    xbc = F.conv1d(xbc.transpose(1, 2), w.t()[:, None, :],
                   p[m + "conv1d.bias"], padding=K - 1,
                   groups=w.shape[1])[..., :T].transpose(1, 2)
    xbc = F.silu(xbc)
    xs, Bm, Cm = xbc.split([di, N, N], dim=-1)
    xs = xs.reshape(Bn, T, nh, hd)
    dt = F.softplus(dt + p[m + "dt_bias"])
    A = -torch.exp(p[m + "A_log"])
    D = p[m + "D"]
    decay = torch.exp(dt * A)[..., None, None]  # (Bn, T, nh, 1, 1)
    inject = (dt[..., None] * xs)[..., None]  # (Bn, T, nh, hd, 1)
    Bt = Bm[:, :, None, None, :]  # (Bn, T, 1, 1, N)
    Ct = Cm[:, :, None, :, None]  # (Bn, T, 1, N, 1)
    S = torch.zeros((Bn, nh, hd, N), device=x.device)
    ys = []
    for t in range(T):
        S = torch.addcmul(decay[:, t] * S, inject[:, t], Bt[:, t])
        ys.append(S @ Ct[:, t])
    y = torch.stack(ys, dim=1)[..., 0] + D[:, None] * xs
    y = y.reshape(Bn, T, di)
    y = _rms(y * F.silu(z), p[m + "norm.weight"], config["rms_norm_eps"])
    return y @ p[m + "out_proj.kernel"]


def _attention(x, p, a, config):
    Bn, T, H = x.shape
    nq, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    ahd = H // nq
    q = (x @ p[a + "q_proj.kernel"]).reshape(Bn, T, nq, ahd).transpose(1, 2)
    k = (x @ p[a + "k_proj.kernel"]).reshape(Bn, T, nkv, ahd).transpose(1, 2)
    v = (x @ p[a + "v_proj.kernel"]).reshape(Bn, T, nkv, ahd).transpose(1, 2)
    k = k.repeat_interleave(nq // nkv, dim=1)
    v = v.repeat_interleave(nq // nkv, dim=1)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    outs = []
    for b in range(Bn):
        s = q[b] @ k[b].transpose(-1, -2) * config["attention_multiplier"]
        s = s.masked_fill(mask, -math.inf)
        outs.append(torch.softmax(s, dim=-1) @ v[b])
    o = torch.stack(outs).transpose(1, 2).reshape(Bn, T, nq * ahd)
    return o @ p[a + "o_proj.kernel"]


def _one(theta, tokens, config):
    p = _unravel(theta, config)
    eps, rm = config["rms_norm_eps"], config["residual_multiplier"]
    ids, target = tokens[:, :-1], tokens[:, 1:]
    E = p["embed_tokens.weight"]
    h = E[ids] * config["embedding_multiplier"]
    for i, kind in enumerate(_kinds(config)):
        pre = f"layers.{i}."
        x = _rms(h, p[pre + "input_layernorm.weight"], eps)
        if kind == "mamba":
            h = h + rm * _mamba(x, p, pre + "mamba.", config)
        else:
            h = h + rm * _attention(x, p, pre + "self_attn.", config)
        x = _rms(h, p[pre + "post_attention_layernorm.weight"], eps)
        g, u = (x @ p[pre + "shared_mlp.input_linear.kernel"]).chunk(2, -1)
        h = h + rm * ((F.silu(g) * u)
                      @ p[pre + "shared_mlp.output_linear.kernel"])
    hn = _rms(h, p["norm.weight"], eps)
    logits = hn @ E.t() / config["logits_scaling"]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         target.reshape(-1))
    return -config["temper"] * ce
