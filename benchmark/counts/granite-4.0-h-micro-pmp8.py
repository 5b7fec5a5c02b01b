"""Operations and bytes of the granite-4.0-h-micro configuration's work,
counted from its shapes as the algorithm needs them.

A superstep evaluates P = N + 1 proposals (binary tree of depth
log2(N + 1)) over ``sequences`` x ``seq_len`` tokens.  For each token and
proposal: every projection 2 * in * out flops (a Mamba layer's in_proj and
out_proj, an attention layer's q, k, v and o, every layer's two MLP
kernels, the tied head), the loss 4 flops a logit (maximum, exponent, sum,
the target's).  For each sequence and proposal, the attention's causal q
k^T and p v, 2 * 2 * heads * head_dim flops a pair of positions (t >= u:
T (T + 1) / 2 pairs).  The SSD recurrence 5 * head_dim * d_state flops a
head and token (decay, outer product, add, and the state times C).  The
norms, the conv, the gates and the softplus are not counted.

Bytes: the P weight sets read once in the configuration's dtype, the
token ids (int64) once, and each scan's x, B, C (in that dtype) and dt
(float32) read once and y written once, with its A and D (float32, per
sequence and head).
"""

from __future__ import annotations

__all__ = ["superstep", "ssd_call", "positions_call"]

_BYTES = {"float32": 4, "bfloat16": 2}


def _P(config: dict) -> int:
    return config["sampler"]["N"] + 1


def _kinds(config: dict) -> list:
    return list(config["layer_types"][:config["num_hidden_layers"]])


def ssd_call(config: dict) -> tuple:
    """(flops, bytes) of one ``mamba2_ssd`` launch: one Mamba layer's scan
    for P proposals' sequences."""
    nh, hd, N = (config["mamba_n_heads"], config["mamba_d_head"],
                 config["mamba_d_state"])
    P, S = _P(config), config["sequences"]
    tokens = P * S * config["seq_len"]
    e = _BYTES[config["dtype"]]
    flops = 5.0 * hd * N * nh * tokens
    nbytes = tokens * (2 * nh * hd * e + 2 * N * e + nh * 4) + P * S * nh * 8
    return flops, float(nbytes)


def positions_call(config: dict) -> tuple:
    """(flops, bytes) of one ``tree_positions_inplace`` launch: the P
    positions of the chain's binary tree written over its P innovations.
    Row x adds scale * eps for each set bit of x (depth * P / 2 of them
    over the rows, a multiply and an add each); the innovations are read
    and written once and the state read once, in float32."""
    P, d = _P(config), config["params"]
    depth = P.bit_length() - 1
    return float(depth * P * d), float((2 * P + 1) * d * 4)


def superstep(config: dict, traffic: dict) -> tuple:
    """(flops, bytes) of one superstep."""
    H, V = config["hidden_size"], config["vocab_size"]
    nh, hd, N = (config["mamba_n_heads"], config["mamba_d_head"],
                 config["mamba_d_state"])
    di = nh * hd
    nq, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    ahd, inter = H // nq, config["shared_intermediate_size"]
    P, S, T = _P(config), config["sequences"], config["seq_len"]
    mamba = 2.0 * H * (2 * di + 2 * N + nh) + 2.0 * di * H
    attention = 2.0 * H * nq * ahd * 2 + 2.0 * 2 * H * nkv * ahd
    mlp = 2.0 * H * 2 * inter + 2.0 * inter * H
    kinds = _kinds(config)
    per_token = (sum(mamba if k == "mamba" else attention for k in kinds)
                 + len(kinds) * mlp + 2.0 * H * V + 4.0 * V)
    flops = P * S * T * per_token
    pairs = T * (T + 1) / 2
    flops += kinds.count("attention") * P * S * 2 * 2.0 * nq * ahd * pairs
    f_ssd, b_ssd = ssd_call(config)
    flops += kinds.count("mamba") * f_ssd
    nbytes = (P * config["params"] * _BYTES[config["dtype"]]
              + S * (T + 1) * 8 + kinds.count("mamba") * b_ssd)
    return flops, float(nbytes)
