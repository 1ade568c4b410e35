"""Shared layer primitives: RMSNorm, RoPE, FFN, dropless MoE (a sorted
loop over experts for prefill, every expert at once for decode), the
capacity MoE and its load-balance loss (training), causal conv.

Counterparts of ``src/repro/models/layers.py``; every function keeps the
reference's dtype at each step (bf16 activations, float32 statistics)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FFNSpec


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (B, S) int. Rotates pairs (2i, 2i+1)."""
    B, H, S, D = x.shape
    inv = rope_freqs(D, theta, x.device)
    ang = positions.float()[:, None, :, None] * inv           # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float().reshape(B, H, S, D // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(B, H, S, D).to(x.dtype)


def _act(h, spec: FFNSpec):
    if spec.activation == "swiglu":
        return F.silu(h)
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h, approximate="tanh")


def apply_ffn(p, x, spec: FFNSpec):
    h = _act(x @ p["w1"], spec)
    if spec.activation in ("swiglu", "geglu"):
        h = h * (x @ p["w3"])
    return h @ p["w2"]


def apply_moe_dropless(p, x, spec: FFNSpec):
    """Exact (dropless) top-k MoE.  Tokens are sorted by expert and each
    expert's contiguous run goes through a plain ``torch.matmul`` (the
    reference's ``lax.ragged_dot`` grouped GEMM).  The combine adds each
    token's k gate-weighted rows in ascending expert id, one add at a time
    in the activation dtype: the order of the reference's sorted
    ``.at[st].add`` and of the CPU's ``index_add_``, fixed on every device
    (CUDA's ``index_add_`` atomics add in no fixed order, so its bits
    would change from call to call)."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    E, k = spec.num_experts, spec.top_k
    order, se, st, sg = _sorted_pairs(*_route(p, x2, k))
    if se.device.type == "meta":
        # a meta tensor holds no routing: for counting only, the T * k
        # rows split evenly over the experts, so the products' FLOPs are
        # the real path's whatever the routing
        counts = [T * k // E + (e < T * k % E) for e in range(E)]
    else:
        counts = torch.bincount(se, minlength=E).tolist()

    xs = x2[st]                                               # (T*k, d)
    ys = torch.empty((T * k, d), dtype=x.dtype, device=x.device)
    lo = 0
    for e, n in enumerate(counts):
        if n:
            xe = xs[lo:lo + n]
            h = _act(xe @ p["w1"][e], spec)
            if spec.activation in ("swiglu", "geglu"):
                h = h * (xe @ p["w3"][e])
            ys[lo:lo + n] = h @ p["w2"][e]
        lo += n
    out = _combine(ys * sg[:, None].to(ys.dtype), order, T, k)
    return _with_shared(p, out, x2, spec).reshape(shape)


def in_token_chunks(moe, p, x, spec: FFNSpec, Q: int = 0):
    """``moe(p, x, spec)`` over chunks of ``Q`` tokens (the
    ``moe_chunk_tokens`` perf flag) when ``Q`` is set and ``x`` holds more
    tokens, the last chunk zero-padded, as the reference's scan over chunks
    (``src/repro/models/layers.py:157-175``): each chunk's capacity is that
    of a whole chunk, and the padding rows come after every real token, so
    they take no real token's slot."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    total = x2.shape[0]
    if not Q or total <= Q:
        return moe(p, x, spec)
    pad = (-total) % Q
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, d))])
    out = torch.cat([moe(p, c, spec) for c in x2.split(Q)])
    return out[:total].reshape(x.shape)


def _combine(contrib, order, T: int, k: int):
    """(T, d): each token's k rows of ``contrib`` (T * k, d), which is in
    the sorted order ``order``, added one at a time in ascending expert id
    (a token's experts are distinct, so ascending sorted positions are
    ascending expert ids): the order of the reference's sorted
    ``.at[st].add``, fixed on every device."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=order.device)
    rows = contrib[torch.sort(inv.reshape(T, k), dim=1).values]  # (T, k, d)
    out = torch.zeros((T, contrib.shape[-1]), dtype=contrib.dtype,
                      device=contrib.device)
    for j in range(k):
        out = out + rows[:, j]
    return out


def _sorted_pairs(gates, idx):
    """The (token, expert) pairs of the top-k ``gates`` / ``idx`` (T, k)
    sorted by expert, stably (as the reference's ``jnp.argsort``): (the
    sort order of the flat pairs, then their experts, tokens and gates in
    it)."""
    T, k = idx.shape
    order = torch.argsort(idx.reshape(-1), stable=True)
    st = torch.arange(T, device=idx.device).repeat_interleave(k)[order]
    return order, idx.reshape(-1)[order], st, gates.reshape(-1)[order]


def moe_capacity(T: int, spec: FFNSpec) -> int:
    """Slots per expert of the capacity MoE for ``T`` tokens."""
    cap = int(T * spec.top_k * spec.capacity_factor / spec.num_experts) + 1
    return max(8, min(cap, T))


def capacity_plan(se, T: int, spec: FFNSpec):
    """The capacity MoE's slots for the sorted pairs' experts ``se``
    (:func:`_sorted_pairs`) of ``T`` tokens: (keep, whether each pair has
    a slot; slot, its slot in the (E * C) buffer, its expert's first where
    dropped).  Within an expert the earlier pairs take the C slots."""
    C = moe_capacity(T, spec)
    # integer adds: the same counts on every device, ``meta`` included
    counts = torch.zeros(spec.num_experts, dtype=se.dtype,
                         device=se.device).index_add_(0, se,
                                                      torch.ones_like(se))
    seg_start = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(se.shape[0], device=se.device) - seg_start[se]
    keep = pos_in_e < C
    return keep, se * C + torch.where(keep, pos_in_e, 0)


def apply_moe(p, x, spec: FFNSpec):
    """Token-choice top-k MoE with capacity drop (training), x: (..., d)
    -> (..., d): each expert takes at most ``moe_capacity`` tokens in
    (E, C, d) products; a pair past its expert's capacity adds nothing.
    The reference's ``_apply_moe_flat`` without ``dropless``
    (``src/repro/models/layers.py:179-238``); its combine is
    :func:`_combine`'s fixed order."""
    shape = x.shape
    d = shape[-1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    E, k = spec.num_experts, spec.top_k
    C = moe_capacity(T, spec)
    order, se, st, sg = _sorted_pairs(*_route(p, x2, k))
    keep, slot = capacity_plan(se, T, spec)

    # each slot's token, T (a zero row) where empty; dropped pairs write
    # the spare entry E * C, which is cut off
    buf_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    buf_tok[torch.where(keep, slot, E * C)] = st
    x_pad = torch.cat([x2, x2.new_zeros((1, d))])
    xs = x_pad[buf_tok[:E * C]].reshape(E, C, d)
    h = _act(torch.bmm(xs, p["w1"]), spec)
    if spec.activation in ("swiglu", "geglu"):
        h = h * torch.bmm(xs, p["w3"])
    ys = torch.bmm(h, p["w2"]).reshape(E * C, d)
    contrib = ys[slot] * sg[:, None].to(ys.dtype)
    contrib = torch.where(keep[:, None], contrib, 0.0)
    return _with_shared(p, _combine(contrib, order, T, k), x2,
                        spec).reshape(shape)


def moe_aux_loss(p, x, spec: FFNSpec):
    """Switch-style load-balance loss of the router on ``x`` (..., d):
    E * sum over experts of (share of top-k picks) x (mean probability),
    float32 (the reference's ``moe_aux_loss``)."""
    x2 = x.reshape(-1, x.shape[-1])
    logits = x2.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    _, idx = torch.topk(logits, spec.top_k, dim=-1)
    onehot = F.one_hot(idx, spec.num_experts).float().sum(1)  # (T, E)
    return spec.num_experts * torch.sum(onehot.mean(0) * probs.mean(0))


def apply_moe_decode(p, x, spec: FFNSpec):
    """The dropless top-k MoE of :func:`apply_moe_dropless` for decode,
    with no host sync, so a CUDA graph can capture it: every expert runs
    over all T tokens as ``(E, T, d) x (E, d, d_ff)`` products, and each
    expert's output is weighted by its gate, zero off the token's top-k.
    The function is the same; only the order of the sum changes.  A step
    reads every expert's weights once, where the sorted loop reads the
    experts its tokens route to (~28 of 32 at 8 slots x top-8; at all 352
    experts of kimi-linear-1t a grouped product on the device would read
    fewer)."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    gates, idx = _route(p, x2, spec.top_k)
    dense = torch.zeros((x2.shape[0], spec.num_experts), dtype=gates.dtype,
                        device=x.device).scatter_(1, idx, gates)  # (T, E)
    h = _act(torch.matmul(x2, p["w1"]), spec)                 # (E, T, d_ff)
    if spec.activation in ("swiglu", "geglu"):
        h = h * torch.matmul(x2, p["w3"])
    ys = torch.matmul(h, p["w2"])                             # (E, T, d)
    out = (ys * dense.T[..., None].to(ys.dtype)).sum(0)
    return _with_shared(p, out, x2, spec).reshape(shape)


def _route(p, x2, k: int):
    """Softmaxed top-k gates (T, k) float32 and their experts (T, k)."""
    gate_logits, idx = torch.topk(x2.float() @ p["router"], k, dim=-1)
    return torch.softmax(gate_logits, dim=-1), idx


def _with_shared(p, out, x2, spec: FFNSpec):
    """Routed output plus the shared experts' dense FFN, where present."""
    if "shared" not in p:
        return out
    shared = FFNSpec(kind="dense", d_ff=spec.d_ff * spec.shared_experts,
                     activation=spec.activation)
    return out + apply_ffn(p["shared"], x2, shared)


def causal_conv1d(x, w, conv_state=None, lengths=None):
    """Depthwise causal conv as K shifted multiply-adds. x: (B, S, C);
    w: (K, C).  Returns (y, new_state = the K-1 inputs ending at each row's
    ``lengths``, or at S when None)."""
    B, S, C = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        # tap i multiplies the input shifted (K-1-i) steps into the past
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    if K <= 1:
        new_state = conv_state
    elif lengths is not None:
        # padded position p lives at xp[p + K - 1]: the window [len-K+1,
        # len) is xp[len : len+K-1]
        idx = lengths.to(x.device).long()[:, None] + torch.arange(
            K - 1, device=x.device)[None]
        new_state = torch.gather(xp, 1, idx[..., None].expand(-1, -1, C))
    else:
        new_state = xp[:, -(K - 1):]
    return y, new_state
