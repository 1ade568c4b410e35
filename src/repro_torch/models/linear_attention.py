"""Bounded-state sequence mixers: KDA/GDN (the gated delta rule), GLA
(Lightning attention: gated linear attention with a sigmoid forget gate,
keys unscaled), Mamba2 (SSD as gated linear attention with a scalar
per-head decay) and xLSTM's two cells: mLSTM (the same gated linear
attention with sigmoid input and forget gates, its normaliser carried as a
ones column of the values, so the state is (dk, dv + 1)) and sLSTM (scalar
memory whose gates read the previous output: a true per-token recurrence,
plain PyTorch as in the reference, which has no kernel for it).

Counterpart of ``src/repro/models/linear_attention.py``, every kind of
``LinearSpec``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LinearSpec
from repro_torch.distributed.local_map import contiguous_grad, splittable
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, rms_norm

SUPPORTED = ("kda", "gdn", "gla", "mamba2", "mlstm", "slstm")


def _check(spec: LinearSpec):
    if spec.kind not in SUPPORTED:
        raise ValueError(f"unknown linear mixer {spec.kind!r} (known: "
                         f"{SUPPORTED})")


def _heads(x, H, D):
    B, S, _ = x.shape
    return contiguous_grad(splittable(x, H).reshape(B, S, H, D)).transpose(
        1, 2)


def _unheads(x):
    B, H, S, D = x.shape
    return contiguous_grad(x.transpose(1, 2).reshape(B, S, H * D), H)


def _l2norm(x, eps=1e-6):
    inv = torch.rsqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True) + eps)
    return x * inv.to(x.dtype)


def _per_head_norm(o, scale, eps=1e-5):
    """RMSNorm over the value dim of (B,H,S,dv), scale (H*dv,)."""
    B, H, S, dv = o.shape
    of = o.float()
    var = torch.mean(of * of, dim=-1, keepdim=True)
    of = of * torch.rsqrt(var + eps)
    return (of * scale.float().reshape(1, H, 1, dv)).to(o.dtype)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _qkv(p, x, spec: LinearSpec, conv_state=None, lengths=None):
    H, dk, dv = spec.heads, spec.key_dim, spec.value_dim
    q = x @ p["wq"]["w"]
    k = x @ p["wk"]["w"]
    v = x @ p["wv"]["w"]
    new_conv = None
    if spec.conv_kernel:
        qkv = torch.cat([q, k, v], dim=-1)
        if lengths is not None:
            # zero padded positions so taps at valid positions only read
            # real inputs (or zeros past the end)
            S = qkv.shape[1]
            mask = torch.arange(S, device=x.device)[None, :] < lengths.to(
                x.device)[:, None]
            qkv = torch.where(mask[..., None], qkv, 0)
        qkv, new_conv = causal_conv1d(qkv, p["conv_w"], conv_state,
                                      lengths=lengths)
        qkv = F.silu(qkv)
        q = qkv[..., :H * dk]
        k = qkv[..., H * dk:2 * H * dk]
        v = qkv[..., 2 * H * dk:]
    return _heads(q, H, dk), _heads(k, H, dk), _heads(v, H, dv), new_conv


def _gates_full(p, x, spec: LinearSpec):
    """Per-token per-head (log_a <= 0, beta), each (B, H, S) float32;
    beta is None for GLA, Mamba2 and mLSTM, which have no write strength.
    GLA's and mLSTM's decay is a sigmoid forget gate biased open (+4)."""
    if spec.kind in ("gla", "mlstm"):
        gate = p["a_proj" if spec.kind == "gla" else "f_proj"]["w"]
        log_a = F.logsigmoid((x @ gate).float() + 4.0)
        return log_a.transpose(1, 2), None
    dt = _softplus(x @ p["a_proj"]["w"] + p["dt_bias"].to(x.dtype))
    log_a = -torch.exp(p["A_log"].float()) * dt.float()
    if spec.kind == "mamba2":
        return log_a.transpose(1, 2), None
    beta = torch.sigmoid((x @ p["b_proj"]["w"]).float())
    return log_a.transpose(1, 2), beta.transpose(1, 2)


def _d_skip(p, o, v):
    """Mamba2's skip term, o + D v in float32 (head axis 1)."""
    shape = (1, -1) + (1,) * (v.dim() - 2)
    return o + p["D_skip"].float().reshape(shape) * v.float()


_SLSTM_LEAVES = ("c", "n", "m", "h")


def state_shapes(spec: LinearSpec, batch: int, dt):
    """The cache leaves of one linear block for ``batch`` requests, as
    {name: (shape, dtype)}: the float32 ``state`` (B, H, dk, dv), with
    mLSTM's normaliser column (dv + 1), and the ``conv`` window (B, K - 1,
    C) in ``dt``; sLSTM's ``state`` is {"c", "n", "m", "h"}, each (B, H,
    dv) float32, with no conv."""
    H, dk, dv = spec.heads, spec.key_dim, spec.value_dim
    if spec.kind == "slstm":
        return {"state": {n: ((batch, H, dv), torch.float32)
                          for n in _SLSTM_LEAVES}}
    dv_state = dv + (1 if spec.kind == "mlstm" else 0)
    c = {"state": ((batch, H, dk, dv_state), torch.float32)}
    if spec.conv_kernel:
        c["conv"] = ((batch, spec.conv_kernel - 1, H * (2 * dk + dv)), dt)
    return c


def _mlstm_keys(p, x, k, spec: LinearSpec):
    """mLSTM's keys: k times the sigmoid input gate (in float32, cast
    back), then times dk^-0.5.  k (B, H, S, dk), x (B, S, d)."""
    i_gate = torch.sigmoid((x @ p["i_proj"]["w"]).float())     # (B, S, H)
    k = (k.float() * i_gate.transpose(1, 2)[..., None]).to(k.dtype)
    return k * (spec.key_dim ** -0.5)


def _with_ones(v):
    """v (..., dv) -> (..., dv + 1) with a ones column (mLSTM's normaliser),
    one contiguous tensor."""
    return torch.cat([v, v.new_ones(v.shape[:-1] + (1,))], dim=-1)


def _normalised(o_aug, dtype):
    """mLSTM's output: the value columns over max(|normaliser|, 1), in
    float32, cast to ``dtype``."""
    num, den = o_aug[..., :-1].float(), o_aug[..., -1:].float()
    return (num / torch.clamp(torch.abs(den), min=1.0)).to(dtype)


def linear_forward(p, x, spec: LinearSpec, *, initial_state=None,
                   conv_state=None, lengths=None, use_kernels=True):
    """Full-sequence (prefill) forward.  Returns (y, cache = {"state":
    (B,H,dk,dv) float32 ((B,H,dk,dv+1) for mLSTM), "conv"}); sLSTM's cache
    is {"state": {"c", "n", "m", "h"}}.

    ``lengths`` (B,): valid tokens per row of a right-padded batch; padded
    positions leave the state untouched and the conv window is taken at
    ``lengths``, so the cache is exactly that of the unpadded prompt."""
    _check(spec)
    if spec.kind == "slstm":
        return _slstm_forward(p, x, spec, initial_state=initial_state,
                              lengths=lengths)
    q, k, v, new_conv = _qkv(p, x, spec, conv_state, lengths=lengths)
    log_a, beta = _gates_full(p, x, spec)
    if spec.kind == "mlstm":
        k = _mlstm_keys(p, x, k, spec)
        o_aug, state = ops.gla(q, k, _with_ones(v), log_a, initial_state,
                               lengths=lengths, use_kernel=use_kernels)
        o = _normalised(o_aug, v.dtype)
    elif spec.kind in ("gla", "mamba2"):
        # GLA's keys go in unscaled and it has no skip term
        if spec.kind == "mamba2":
            k = k * (spec.key_dim ** -0.5)
        o, state = ops.gla(q, k, v, log_a, initial_state, lengths=lengths,
                           use_kernel=use_kernels)
        if spec.kind == "mamba2":
            o = _d_skip(p, o, v)
    else:
        k = _l2norm(k)
        q = _l2norm(q)
        o, state = ops.delta(q, k, v, log_a, beta, initial_state,
                             lengths=lengths, use_kernel=use_kernels)
    o = _per_head_norm(o.to(x.dtype), p["g_norm"])
    g = F.silu(x @ p["g_proj"]["w"])
    y = (_unheads(o) * g) @ p["wo"]["w"]
    cache = {"state": state}
    if spec.conv_kernel:
        cache["conv"] = new_conv
    return y, cache


def linear_decode(p, x, spec: LinearSpec, cache):
    """x: (B,1,d); cache {"state", "conv"} -> (y, new cache)."""
    _check(spec)
    if spec.kind == "slstm":
        return _slstm_decode(p, x, spec, cache)
    B = x.shape[0]
    q, k, v, new_conv = _qkv(p, x, spec, cache.get("conv"))
    log_a, beta = _gates_full(p, x, spec)
    q1, k1, v1 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    if spec.kind == "mlstm":
        k1 = _mlstm_keys(p, x, k, spec)[:, :, 0]
        o_aug, state = ops.gla_step(q1, k1, _with_ones(v1), log_a[:, :, 0],
                                    cache["state"])
        o = _normalised(o_aug, v1.dtype)
    elif spec.kind in ("gla", "mamba2"):
        if spec.kind == "mamba2":
            k1 = k1 * (spec.key_dim ** -0.5)
        o, state = ops.gla_step(q1, k1, v1, log_a[:, :, 0], cache["state"])
        if spec.kind == "mamba2":
            o = _d_skip(p, o, v1)
    else:
        k1 = _l2norm(k1)
        q1 = _l2norm(q1)
        o, state = ops.delta_step(q1, k1, v1, log_a[:, :, 0],
                                  beta[:, :, 0], cache["state"])
    o = _per_head_norm(o[:, :, None].to(x.dtype), p["g_norm"])[:, :, 0]
    g = F.silu(x[:, 0] @ p["g_proj"]["w"])
    y = ((o.reshape(B, -1) * g) @ p["wo"]["w"])[:, None]
    new_cache = {"state": state}
    if spec.conv_kernel:
        new_cache["conv"] = new_conv
    return y, new_cache


# ---------------------------------------------------------------------------
# sLSTM: scalar memory, gates fed back from the previous output
# ---------------------------------------------------------------------------


def _slstm_step(p, spec: LinearSpec, gx, state):
    """One token.  gx: the input's gate pre-activations x_t @ w_gates, (B,
    H, 4 dv) in the activation dtype; state (c, n, m, h), each (B, H, dv)
    float32.  The reference's op order: h cast to ``r_gates``' dtype for
    the recurrent product, gx + gh added in that dtype, then float32 plus
    ``b_gates``."""
    c, n, m, h = state
    H, dv = spec.heads, spec.value_dim
    r = p["r_gates"]
    gh = torch.einsum("bhv,hvu->bhu", h.to(r.dtype), r)
    g = (gx + gh).float() + p["b_gates"].reshape(H, 4 * dv)
    i_t, f_t, z_t, o_t = torch.split(g, dv, dim=-1)
    log_fm = F.logsigmoid(f_t) + m
    m_new = torch.maximum(log_fm, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_fm - m_new)
    c = f_p * c + i_p * torch.tanh(z_t)
    n = f_p * n + i_p
    h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1.0)
    return c, n, m_new, h


def _slstm_out(p, hs, dtype):
    """Output projection of the cell outputs hs (..., H, dv) float32."""
    o = rms_norm(hs.reshape(hs.shape[:-2] + (-1,)).to(dtype), p["g_norm"])
    return o @ p["wo"]["w"]


def _slstm_forward(p, x, spec: LinearSpec, *, initial_state=None,
                   lengths=None):
    """The recurrence over the S tokens of x (B, S, d), one step a token
    (the reference's ``lax.scan``); the input product x @ w_gates is taken
    for the whole chunk first.  With ``lengths`` every leaf holds its
    value at each row's padded positions, so the state is the one after
    the row's real tokens.  The held steps are not computed: the steps
    before the shortest row's length need no hold, and past the longest
    every row holds, so those positions' outputs are the last ones (the
    lengths are read on the host once a call; a prefill is never
    captured)."""
    B, S, _ = x.shape
    H, dv = spec.heads, spec.value_dim
    if initial_state is None:
        initial_state = {n: torch.zeros(shape, dtype=dtype, device=x.device)
                         for n, (shape, dtype) in
                         state_shapes(spec, B, x.dtype)["state"].items()}
    state = tuple(initial_state[n] for n in _SLSTM_LEAVES)
    gx = (x @ p["w_gates"]["w"]).reshape(B, S, H, 4 * dv)
    n_min = n_max = S
    if lengths is not None:
        lengths = lengths.to(x.device)
        n_min, n_max = (min(max(int(v), 0), S) for v in
                        torch.stack([lengths.min(), lengths.max()]).tolist())
        valid = (torch.arange(S, device=x.device)[:, None]
                 < lengths[None, :])[..., None, None]
    hs = []
    for t in range(n_max):
        new = _slstm_step(p, spec, gx[:, t], state)
        if t >= n_min:
            new = tuple(torch.where(valid[t], nw, old)
                        for nw, old in zip(new, state))
        state = new
        hs.append(state[3])
    hs = torch.stack(hs, dim=1) if hs else state[3][:, None][:, :0]
    if n_max < S:
        hs = torch.cat([hs, state[3][:, None].expand(B, S - n_max, H, dv)],
                       dim=1)
    y = _slstm_out(p, hs, x.dtype)
    return y, {"state": dict(zip(_SLSTM_LEAVES, state))}


def _slstm_decode(p, x, spec: LinearSpec, cache):
    B = x.shape[0]
    s = cache["state"]
    gx = (x[:, 0] @ p["w_gates"]["w"]).reshape(B, spec.heads,
                                                4 * spec.value_dim)
    state = _slstm_step(p, spec, gx, tuple(s[n] for n in _SLSTM_LEAVES))
    y = _slstm_out(p, state[3], x.dtype)[:, None]
    return y, {"state": dict(zip(_SLSTM_LEAVES, state))}
