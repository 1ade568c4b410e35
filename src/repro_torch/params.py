"""Parameters of the port: carried over from the reference, or drawn anew.

:func:`from_numpy_tree` turns the reference's parameter tree, given as
numpy arrays (what ``jax.tree.map(np.asarray, repro.models.Model(cfg)
.init(key))`` returns), into the port's tree of tensors with the same keys
and the same group layout: ``"stacked"`` ``(R, ...)`` leaves, and one
unstacked tree per shared block under ``"shared"``.  bfloat16 leaves cross
bit-exactly through their uint16 bit patterns.

:func:`init_params` draws a tree of the same structure on any device from a
``torch.Generator``, with the reference's distributions
(``src/repro/models/model.py:63-124`` and the ``init_*`` helpers it calls):
normal weights scaled by fan-in^-0.5, embeddings at 0.02, norm scales at
one, decay parameters at zero.  It does not reproduce the reference's
random bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (AttentionSpec, BlockSpec, FFNSpec,
                                      ModelConfig)
from repro_torch.models.model import _check_supported, torch_dtype
from repro_torch.models.tree import tree_leaves


def _to_tensor(x, device):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def requires_grad(tree, flag: bool = True):
    """Mark every leaf of ``tree`` (in place) as a leaf tensor that
    autograd differentiates (``flag``) or not; returns ``tree``."""
    for leaf in tree_leaves(tree):
        leaf.requires_grad_(flag)
    return tree


def from_numpy_tree(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_numpy_tree(v, device) for v in tree]
    return _to_tensor(tree, device)


class _Draw:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, std, dtype=None):
        x = torch.randn(shape, generator=self.g, device=self.device,
                        dtype=dtype or self.dtype)
        return x.mul_(std)

    def const(self, shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _linear(dr, lead, d_in, d_out):
    return {"w": dr.normal(lead + (d_in, d_out), d_in ** -0.5)}


def _ffn(dr, lead, d, spec: FFNSpec):
    p = {"w1": dr.normal(lead + (d, spec.d_ff), d ** -0.5),
         "w2": dr.normal(lead + (spec.d_ff, d), spec.d_ff ** -0.5)}
    if spec.activation in ("swiglu", "geglu"):
        p["w3"] = dr.normal(lead + (d, spec.d_ff), d ** -0.5)
    return p


def _moe(dr, lead, d, spec: FFNSpec):
    E, Fd = spec.num_experts, spec.d_ff
    p = {"router": dr.normal(lead + (d, E), d ** -0.5, torch.float32),
         "w1": dr.normal(lead + (E, d, Fd), d ** -0.5),
         "w2": dr.normal(lead + (E, Fd, d), Fd ** -0.5)}
    if spec.activation in ("swiglu", "geglu"):
        p["w3"] = dr.normal(lead + (E, d, Fd), d ** -0.5)
    if spec.shared_experts:
        shared = FFNSpec(kind="dense", d_ff=Fd * spec.shared_experts,
                         activation=spec.activation)
        p["shared"] = _ffn(dr, lead, d, shared)
    return p


def _gqa(dr, lead, d, m: AttentionSpec):
    H, Hkv, D = m.q_heads, m.kv_heads, m.head_dim
    mx = {"wq": _linear(dr, lead, d, H * D),
          "wk": _linear(dr, lead, d, Hkv * D),
          "wv": _linear(dr, lead, d, Hkv * D),
          "wo": _linear(dr, lead, H * D, d)}
    if m.qkv_bias:
        for name in ("wq", "wk", "wv"):
            mx[name]["b"] = dr.const(lead + (mx[name]["w"].shape[-1],),
                                     0.0, dr.dtype)
    return mx


def _block(dr, lead, d, spec: BlockSpec):
    p = {"ln1": dr.const(lead + (d,), 1.0)}
    m = spec.mixer
    if isinstance(m, AttentionSpec) and m.kind != "mla":     # GQA
        mx = _gqa(dr, lead, d, m)
    elif isinstance(m, AttentionSpec):        # MLA
        H, D, R, Rp = m.q_heads, m.head_dim, m.mla_kv_rank, m.mla_rope_dim
        mx = {}
        if m.mla_q_rank:
            mx["wq_a"] = _linear(dr, lead, d, m.mla_q_rank)
            mx["q_norm"] = dr.const(lead + (m.mla_q_rank,), 1.0)
            mx["wq_b"] = _linear(dr, lead, m.mla_q_rank, H * (D + Rp))
        else:
            mx["wq"] = _linear(dr, lead, d, H * (D + Rp))
        mx["wkv_a"] = _linear(dr, lead, d, R + Rp)
        mx["kv_norm"] = dr.const(lead + (R,), 1.0)
        mx["wkv_b"] = _linear(dr, lead, R, m.kv_heads * 2 * D)
        mx["wo"] = _linear(dr, lead, H * D, d)
    elif m.kind == "slstm":                   # no q/k/v, no conv
        H, dv = m.heads, m.value_dim
        mx = {"w_gates": _linear(dr, lead, d, 4 * H * dv),
              "r_gates": dr.normal(lead + (H, dv, 4 * dv), dv ** -0.5),
              "b_gates": dr.const(lead + (4 * H * dv,), 0.0),
              "wo": _linear(dr, lead, H * dv, d),
              "g_norm": dr.const(lead + (H * dv,), 1.0)}
    else:                                 # KDA / GDN / GLA / Mamba2 / mLSTM
        H, dk, dv = m.heads, m.key_dim, m.value_dim
        mx = {"wq": _linear(dr, lead, d, H * dk),
              "wk": _linear(dr, lead, d, H * dk),
              "wv": _linear(dr, lead, d, H * dv),
              "wo": _linear(dr, lead, H * dv, d),
              "g_proj": _linear(dr, lead, d, H * dv),
              "g_norm": dr.const(lead + (H * dv,), 1.0)}
        if m.kind == "mlstm":
            mx["i_proj"] = _linear(dr, lead, d, H)
            mx["f_proj"] = _linear(dr, lead, d, H)
        else:
            mx["a_proj"] = _linear(dr, lead, d, H)
        if m.kind in ("kda", "gdn", "mamba2"):   # GLA's gate has no rate
            mx["A_log"] = dr.const(lead + (H,), 0.0)
            mx["dt_bias"] = dr.const(lead + (H,), 0.0)
        if m.kind == "mamba2":
            mx["D_skip"] = dr.const(lead + (H,), 0.0)
        elif m.kind in ("kda", "gdn"):
            mx["b_proj"] = _linear(dr, lead, d, H)
        if m.conv_kernel:
            C = H * (2 * dk + dv)
            mx["conv_w"] = dr.normal(lead + (m.conv_kernel, C),
                                     m.conv_kernel ** -0.5)
    p["mixer"] = mx
    if spec.cross is not None:
        p["ln_cross"] = dr.const(lead + (d,), 1.0)
        p["cross"] = _gqa(dr, lead, d, spec.cross)
    if spec.ffn.kind in ("dense", "moe"):
        p["ln2"] = dr.const(lead + (d,), 1.0)
        make = _ffn if spec.ffn.kind == "dense" else _moe
        p["ffn"] = make(dr, lead, d, spec.ffn)
    return p


def _groups(dr, d, groups):
    return [{"stacked": {f"b{bi}": _block(dr, (g.repeats,), d, b)
                         for bi, b in enumerate(g.blocks) if not b.shared},
             "shared": {f"b{bi}": _block(dr, (), d, b)
                        for bi, b in enumerate(g.blocks) if b.shared}}
            for g in groups]


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """A seeded parameter tree for ``cfg`` on ``device`` (see module doc):
    an encoder-decoder's also holds ``enc_groups``, ``enc_norm`` and
    ``enc_proj``, and cross blocks ``ln_cross`` / ``cross``; a VLM's
    ``patch_proj``."""
    _check_supported(cfg)
    dr = _Draw(generator, device, torch_dtype(cfg))
    d, V = cfg.d_model, cfg.vocab_size
    p = {"embed": dr.normal((V, d), 0.02),
         "final_norm": dr.const((d,), 1.0),
         "groups": _groups(dr, d, cfg.groups)}
    if not cfg.tie_embeddings:
        p["unembed"] = dr.normal((d, V), 0.02)
    if cfg.encoder_groups:
        p["enc_groups"] = _groups(dr, d, cfg.encoder_groups)
        p["enc_norm"] = dr.const((d,), 1.0)
        if cfg.encoder_input_dim:
            p["enc_proj"] = _linear(dr, (), cfg.encoder_input_dim, d)
    if cfg.num_image_patches:
        p["patch_proj"] = _linear(dr, (), d, d)
    return p
