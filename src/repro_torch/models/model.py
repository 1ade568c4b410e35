"""Model API: prefill / prefill_chunk / last_logits / decode_step of the
serving path, train_loss of the training path, plus the decode cache
builders.

Counterpart of ``src/repro/models/model.py``.  Parameters are the
reference's tree as plain dicts of tensors (``repro_torch.params``), with
each group's blocks stacked over its repeats as ``(R, ...)`` leaves under
``"stacked"``, and a shared (parameter-tied) block's one unstacked tree
under ``"shared"``; a Python loop over the repeats replaces ``lax.scan``.
Caches keep the reference's keys and shapes: ``{"groups": [{"b0":
{"state", "conv"}, ..., "b3": {"ckv", "kpe"}}]}`` with stacked ``(R, B, S,
...)`` leaves; every block invocation, shared or not, has its own cache.

Full-attention blocks cache ``{"k", "v"}`` (R, B, S, Hkv, D).  With
``tables`` (paged KV, ``repro_torch.models.paged``) the attention leaves
of the caches are shared page pools instead, addressed through per-slot
block tables.

The serving path's MoE is always the exact dropless form (the reference's
inference default).  Architectures whose blocks the port does not serve
yet (encoders, image prefixes, cross-attention, sliding windows, mixers
other than KDA/GDN, Mamba2, GQA and MLA) raise ``NotImplementedError`` at
construction.  Training (``train_loss``) builds no caches; it runs dense
and FFN-less blocks, and raises ``NotImplementedError`` on a MoE block
(capacity MoE and its aux loss are ROADMAP A10).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionSpec, BlockSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear_attention as lin_mod
from repro_torch.models.layers import apply_ffn, apply_moe_dropless, rms_norm
from repro_torch.models.tree import tree_map, tree_map_named


def torch_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: ModelConfig):
    if cfg.encoder_groups is not None or cfg.num_image_patches:
        raise NotImplementedError("encoder / image-prefix models are not "
                                  "ported yet")
    for g in cfg.groups:
        for b in g.blocks:
            if b.cross is not None:
                raise NotImplementedError("cross-attention blocks are not "
                                          "ported yet")
            m = b.mixer
            if isinstance(m, AttentionSpec):
                attn_mod._check(m)
            else:
                lin_mod._check(m)


def _rep(tree, r: int):
    """Repeat ``r`` of a stacked (R, ...) tree (views, no copy)."""
    return tree_map(lambda x: x[r], tree)


def _block_params(g, gp, r: int):
    """{"b<i>": params} of repeat ``r`` of group ``g``: a view of the
    stacked leaves, or the shared block's one tree."""
    pr = _rep(gp["stacked"], r)
    return {f"b{bi}": gp["shared"][f"b{bi}"] if b.shared else pr[f"b{bi}"]
            for bi, b in enumerate(g.blocks)}


def _unbind_reps(tree, R: int):
    """The ``R`` repeats of a stacked (R, ...) tree, each leaf split by one
    ``unbind``, whose backward stacks the repeats' gradients once (a
    ``x[r]`` per repeat would materialise a zero (R, ...) gradient for
    each)."""
    if isinstance(tree, dict):
        parts = {k: _unbind_reps(v, R) for k, v in tree.items()}
        return [{k: parts[k][r] for k in tree} for r in range(R)]
    return list(tree.unbind(0))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# leaves of a table-direct prior (``paged.build_prior``) that pass through a
# chunk unchanged: the whole stacked pool, never restacked
_PRIOR_LEAVES = ("pk", "pv", "tbl", "off")


def _stack_reps(reps, prior):
    """Stack per-repeat block caches; the table-direct leaves of ``prior``
    (the group's stacked input caches) are carried as they are."""
    out = {}
    for key in reps[0]:
        keep = {n: prior[key][n] for n in _PRIOR_LEAVES
                if prior is not None and n in prior[key]}
        fresh = [{n: v for n, v in rc[key].items() if n not in keep}
                 for rc in reps]
        out[key] = {**_stack(fresh), **keep}
    return out


class Model:
    """Functional model over a parameter tree; ``use_kernels=False`` routes
    every kernel op to its plain PyTorch version on any device (for the
    comparisons in tests and ``chip_smoke.py``).  ``remat``: training
    recomputes each repeat's activations in the backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``."""

    # sequence chunk of the cross-entropy: bounds the transient (B, C, V)
    # float32 logits
    CE_CHUNK = 512

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True,
                 remat: bool = False):
        _check_supported(cfg)
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.remat = remat

    # ------------------------------------------------------------ blocks
    def _ffn(self, spec: BlockSpec, p, x):
        f = spec.ffn
        if f.kind == "dense":
            return x + apply_ffn(p["ffn"], rms_norm(x, p["ln2"],
                                                     self.cfg.norm_eps), f)
        if f.kind == "moe":
            return x + apply_moe_dropless(
                p["ffn"], rms_norm(x, p["ln2"], self.cfg.norm_eps), f)
        return x

    def _apply_block(self, spec: BlockSpec, p, x, positions, lengths,
                     cache=None):
        """Full-sequence block (``cache`` given: a chunk continuing from the
        prior chunks' cache).  Returns (x, cache)."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        m = spec.mixer
        kw = dict(use_kernels=self.use_kernels)
        if isinstance(m, AttentionSpec):
            if cache is None:
                y, c = attn_mod.attention_forward(p["mixer"], h, m,
                                                  positions, **kw)
            else:
                y, c = attn_mod.attention_forward_chunk(p["mixer"], h, m,
                                                        positions, cache,
                                                        **kw)
        else:
            y, c = lin_mod.linear_forward(
                p["mixer"], h, m,
                initial_state=None if cache is None else cache["state"],
                conv_state=None if cache is None else cache.get("conv"),
                lengths=lengths, **kw)
        return self._ffn(spec, p, x + y), c

    def _decode_block(self, spec: BlockSpec, p, x, cache, lengths,
                      tables=None, page_tokens=None, capacity=None):
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        m = spec.mixer
        if isinstance(m, AttentionSpec) and tables is not None:
            y, c = attn_mod.attention_decode_paged(
                p["mixer"], h, m, cache, lengths, tables,
                page_tokens=page_tokens, capacity=capacity,
                use_kernels=self.use_kernels)
        elif isinstance(m, AttentionSpec):
            y, c = attn_mod.attention_decode(p["mixer"], h, m, cache, lengths,
                                             use_kernels=self.use_kernels)
        else:
            y, c = lin_mod.linear_decode(p["mixer"], h, m, cache)
        return self._ffn(spec, p, x + y), c

    def _run_groups(self, params, x, positions, lengths, caches=None):
        """Every group's repeats in order.  Returns (x, stacked caches)."""
        out = []
        for gi, (g, gp) in enumerate(zip(self.cfg.groups, params["groups"])):
            reps = []
            for r in range(g.repeats):
                pr = _block_params(g, gp, r)
                cr = None if caches is None else _rep(caches[gi], r)
                rc = {}
                for bi, b in enumerate(g.blocks):
                    key = f"b{bi}"
                    x, rc[key] = self._apply_block(
                        b, pr[key], x, positions, lengths,
                        None if cr is None else cr[key])
                reps.append(rc)
            out.append(_stack_reps(reps, None if caches is None
                                   else caches[gi]))
        return x, out

    def _train_groups(self, params, x, positions):
        """Every group's repeats in order, building no caches; each repeat
        under ``checkpoint`` with ``remat``."""
        for g, gp in zip(self.cfg.groups, params["groups"]):
            reps = (_unbind_reps(gp["stacked"], g.repeats) if gp["stacked"]
                    else [{}] * g.repeats)

            def body(x, pr, _g=g, _gp=gp):
                for bi, b in enumerate(_g.blocks):
                    key = f"b{bi}"
                    p = _gp["shared"][key] if b.shared else pr[key]
                    x, _ = self._apply_block(b, p, x, positions, None)
                return x

            for pr in reps:
                x = (checkpoint(body, x, pr, use_reentrant=False)
                     if self.remat else body(x, pr))
        return x

    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x.float() @ w.float()

    # --------------------------------------------------------------- API
    def train_loss(self, params, batch):
        """batch: {"tokens": (B, S + 1) int}.  Mean next-token
        cross-entropy of ``tokens[:, 1:]`` given ``tokens[:, :-1]``.
        Returns (total, {"ce", "aux"}): ``aux`` is the MoE load-balance
        loss, a float32 zero for the dense and FFN-less blocks trained
        here, so ``total`` is ``ce``."""
        cfg = self.cfg
        if any(b.ffn.kind == "moe" for g in cfg.groups for b in g.blocks):
            raise NotImplementedError("training a MoE block (capacity MoE "
                                      "and its aux loss) is not ported yet "
                                      "(ROADMAP A10)")
        tokens = torch.as_tensor(batch["tokens"]).to(
            params["embed"].device).long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        B, S = inputs.shape
        x = params["embed"][inputs]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x = self._train_groups(params, x, positions)
        loss = self._chunked_ce(params, x, labels)
        return loss, {"ce": loss, "aux": torch.zeros(
            (), dtype=torch.float32, device=x.device)}

    def _ce_chunk(self, params, xb, lb, vb):
        """Summed log-likelihood of one chunk's valid labels."""
        logp = torch.log_softmax(self._logits(params, xb), dim=-1)
        ll = torch.gather(logp, -1, lb[..., None])[..., 0]
        return torch.sum(ll * vb[None, :])

    def _chunked_ce(self, params, x, labels):
        """Exact mean CE over chunks of ``CE_CHUNK`` positions (the last
        padded and masked), each chunk's logits recomputed in the backward:
        the (B, S, V) logits never exist at once."""
        B, S, _ = x.shape
        C = min(self.CE_CHUNK, S)
        pad = (-S) % C
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad))
        valid = (torch.arange(S + pad, device=x.device) < S).float()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S + pad, C):
            total = total + checkpoint(
                self._ce_chunk, params, x[:, c0:c0 + C],
                labels[:, c0:c0 + C], valid[c0:c0 + C], use_reentrant=False)
        return -total / (B * S)

    def prefill(self, params, batch):
        """batch: {"tokens": (B, S) int, "lengths": (B,) optional}.
        Returns (last-token logits (B, V) float32, caches).  With
        ``lengths`` the logits are taken at each row's ``lengths - 1`` and
        linear-mixer states stop at each row's length, so a right-padded
        batch gives exactly its unpadded results."""
        tokens = batch["tokens"]
        lengths = batch.get("lengths")
        B, S = tokens.shape
        x = params["embed"][tokens]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, caches = self._run_groups(params, x, positions, lengths)
        if lengths is not None:
            x_last = x[torch.arange(B, device=x.device),
                       lengths.to(x.device).long() - 1][:, None]
        else:
            x_last = x[:, -1:]
        return self._logits(params, x_last)[:, 0], {"groups": caches}

    def prefill_chunk(self, params, batch, caches=None):
        """One chunk of an incremental prefill.  batch: {"tokens": (B, C),
        "positions": (B, C) absolute, "lengths": (B,) valid tokens within
        this chunk}.  ``caches=None`` starts the prefill.  Returns (hidden
        (B, C, d) before the final norm, caches)."""
        x = params["embed"][batch["tokens"]]
        positions = batch["positions"].long()
        lengths = batch.get("lengths")
        x, gc = self._run_groups(
            params, x, positions, lengths,
            None if caches is None else caches["groups"])
        return x, {"groups": gc}

    def last_logits(self, params, hidden, lengths):
        """Logits (B, V) at each row's ``lengths - 1`` of hidden (B, S, d)."""
        B = hidden.shape[0]
        idx = lengths.to(hidden.device).long() - 1
        x_last = hidden[torch.arange(B, device=hidden.device), idx][:, None]
        return self._logits(params, x_last)[:, 0]

    def decode_step(self, params, tokens, caches, lengths, tables=None,
                    page_tokens=None, capacity=None):
        """tokens (B,) int; lengths (B,) context sizes.  Returns (logits
        (B, V) float32, caches).  The caches are updated in place (the
        stacked buffers of ``caches`` are the returned ones).

        ``tables``: paged-KV block tables ``{"seq": (B, capacity / T)
        int32}`` on the device; ``caches`` then holds page-pool leaves
        (``models/paged.py``) and ``page_tokens`` / ``capacity`` give the
        page size and the slot capacity."""
        x = params["embed"][tokens[:, None]]
        for gi, (g, gp) in enumerate(zip(self.cfg.groups, params["groups"])):
            gc = caches["groups"][gi]
            for r in range(g.repeats):
                pr = _block_params(g, gp, r)
                for bi, b in enumerate(g.blocks):
                    key = f"b{bi}"
                    cur = _rep(gc[key], r)
                    x, new = self._decode_block(b, pr[key], x, cur, lengths,
                                                tables, page_tokens, capacity)
                    for name, t in new.items():
                        if t.data_ptr() != cur[name].data_ptr():
                            gc[key][name][r].copy_(t)
        return self._logits(params, x)[:, 0], caches

    def init_cache(self, batch_size: int, capacity: int, device):
        """Zeroed decode cache buffers of sequence capacity ``capacity``."""
        cfg = self.cfg
        dt = torch_dtype(cfg)
        B = batch_size

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        groups = []
        for g in cfg.groups:
            gc = {}
            R = g.repeats
            for bi, b in enumerate(g.blocks):
                m = b.mixer
                if isinstance(m, AttentionSpec) and m.kind == "mla":
                    gc[f"b{bi}"] = {
                        "ckv": zeros((R, B, capacity, m.mla_kv_rank), dt),
                        "kpe": zeros((R, B, capacity, m.mla_rope_dim), dt)}
                elif isinstance(m, AttentionSpec):
                    shape = (R, B, capacity, m.kv_heads, m.head_dim)
                    gc[f"b{bi}"] = {"k": zeros(shape, dt),
                                    "v": zeros(shape, dt)}
                else:
                    c = {"state": zeros((R, B, m.heads, m.key_dim,
                                         m.value_dim), torch.float32)}
                    if m.conv_kernel:
                        C = m.heads * (2 * m.key_dim + m.value_dim)
                        c["conv"] = zeros((R, B, m.conv_kernel - 1, C), dt)
                    gc[f"b{bi}"] = c
            groups.append(gc)
        return {"groups": groups}


def _pad_seq(x, to: int):
    """Zero-pad axis 2 (sequence) of a (R, B, S, ...) leaf to ``to`` rows."""
    pad = to - x.shape[2]
    if pad <= 0:
        return x
    z = torch.zeros(x.shape[:2] + (pad,) + x.shape[3:], dtype=x.dtype,
                    device=x.device)
    return torch.cat([x, z], dim=2)


def prepare_decode_caches(cfg: ModelConfig, caches, capacity: int):
    """Place prefill-produced caches into decode buffers of ``capacity``:
    GQA K/V and MLA latents are zero-padded to capacity, O(1) states pass
    through."""
    out = []
    for g, gc in zip(cfg.groups, caches["groups"]):
        placed = {}
        for bi, b in enumerate(g.blocks):
            c = gc[f"b{bi}"]
            if isinstance(b.mixer, AttentionSpec):
                c = {k: _pad_seq(v, capacity) for k, v in c.items()}
            placed[f"b{bi}"] = c
        out.append(placed)
    return {"groups": out}


def extend_caches(caches, extra: int):
    """Grow the sequence capacity of prefill caches by ``extra`` zero rows
    so decode can append."""
    return tree_map_named(
        lambda name, x: (_pad_seq(x, x.shape[2] + extra)
                         if name in ("k", "v", "ckv", "kpe") else x), caches)
