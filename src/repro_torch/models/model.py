"""Model API: prefill / prefill_chunk / last_logits / decode_step and the
speculative decode_verify / commit_verify of the serving path, train_loss
of the training path, plus the decode cache builders.

Counterpart of ``src/repro/models/model.py``.  Parameters are the
reference's tree as plain dicts of tensors (``repro_torch.params``), with
each group's blocks stacked over its repeats as ``(R, ...)`` leaves under
``"stacked"``, and a shared (parameter-tied) block's one unstacked tree
under ``"shared"``; a Python loop over the repeats replaces ``lax.scan``.
Caches keep the reference's keys and shapes: ``{"groups": [{"b0":
{"state", "conv"}, ..., "b3": {"ckv", "kpe"}}]}`` with stacked ``(R, B, S,
...)`` leaves (sLSTM's ``state`` is itself a dict, ``{"c", "n", "m",
"h"}``); every block invocation, shared or not, has its own cache.

Full-attention blocks cache ``{"k", "v"}`` (R, B, S, Hkv, D),
sliding-window ones the same leaves as rings of ``min(window, S)`` rows.  With
``tables`` (paged KV, ``repro_torch.models.paged``) the attention leaves
of the caches are shared page pools instead, addressed through per-slot
block tables.

The serving path's MoE is the exact dropless form (the reference's
inference default; a perf variant's token cap sends a larger batch to the
capacity form): a sorted loop over experts in prefill, every expert at
once in decode, where it must not sync the host.

An encoder-decoder (``cfg.encoder_groups``: ``batch["frames"]`` through
``enc_proj``, sinusoidal positions, the encoder's bidirectional groups and
``enc_norm``; decoder blocks with a cross-attention sub-block, caches
``{"self", "cross"}``, sinusoidal positions on the decoder's tokens) and a
VLM (``cfg.num_image_patches``: ``batch["patches"]`` through
``patch_proj``, prepended to the tokens) run through :meth:`prefill` and
:meth:`decode_step`, the reference's whole surface for them; the chunked
prefill and the speculative verify refuse them, as the paged layout and the
serving engines do.  Training (``train_loss``) builds no caches and runs
every architecture the reference trains: a MoE block takes the capacity
form (:func:`layers.apply_moe`) and adds its load-balance loss, as the
reference's training does; an encoder-decoder backpropagates through its
encoder, and a VLM's patch positions are left out of the loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttentionSpec, BlockSpec, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import linear_attention as lin_mod
from repro_torch.models.layers import (apply_ffn, apply_moe,
                                       apply_moe_decode, apply_moe_dropless,
                                       in_token_chunks, moe_train, rms_norm)
from repro_torch.models.perf_flags import PerfFlags
from repro_torch.models.tree import tree_map, tree_map_named


# weight of the MoE load-balance loss in the training loss (the
# reference's ``AUX_LOSS_WEIGHT``), per decoder layer
AUX_LOSS_WEIGHT = 0.01


def torch_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: ModelConfig):
    for g in cfg.groups + (cfg.encoder_groups or ()):
        for b in g.blocks:
            m = b.mixer
            if isinstance(m, AttentionSpec):
                attn_mod._check(m)
            else:
                lin_mod._check(m)
            if b.cross is not None:
                attn_mod._check(b.cross)


def token_only(cfg: ModelConfig) -> bool:
    """A decoder-only model of tokens alone: no encoder, no image prefix.
    The serving engines, the paged layout, the chunked prefill and the
    speculative verify take only these, as the reference's do."""
    return cfg.encoder_groups is None and not cfg.num_image_patches


def require_token_only(cfg: ModelConfig, what: str):
    if not token_only(cfg):
        raise ValueError(f"{what} supports decoder-only token models (no "
                         f"encoder / image prefix); {cfg.name} runs through "
                         "Model.prefill and Model.decode_step only")


def sinusoidal_positions(positions, d_model: int):
    """positions (B, S) -> (B, S, d_model) float32 [sin | cos] embedding
    (the reference's ``sinusoidal_positions``)."""
    half = d_model // 2
    dev = positions.device
    freq = torch.exp(-torch.log(torch.full((), 10000.0, device=dev))
                     * torch.arange(half, dtype=torch.float32, device=dev)
                     / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def _copy_new(stacked, cur, new, r: int):
    """Copy each leaf of ``new`` that is not the view ``cur`` of repeat
    ``r`` into the stacked cache, walking nested leaves (sLSTM's
    {"state": {"c", "n", "m", "h"}})."""
    for name, t in new.items():
        if isinstance(t, dict):
            _copy_new(stacked[name], cur[name], t, r)
        elif t.data_ptr() != cur[name].data_ptr():
            stacked[name][r].copy_(t)


def _state_leaves(block_cache):
    """A block cache's O(1) mixer subtrees (``state``, which is nested for
    sLSTM, and ``conv``): every entry but the attention sequence
    leaves."""
    return {n: v for n, v in block_cache.items() if n not in _ATTN_LEAVES}


# leaves of a table-direct prior (``paged.build_prior``) that pass through a
# chunk unchanged: the whole stacked pool, never restacked
_PRIOR_LEAVES = ("pk", "pv", "tbl", "off")
# sequence leaves of the attention blocks: a speculative verify's rejected
# rows in them are rewritten before they are read, so they need no rollback
_ATTN_LEAVES = ("k", "v", "ckv", "kpe")


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
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
    ``perf``: the MoE's perf flags (``models/perf_flags.py``; the default
    is the baseline, which changes nothing)."""

    # sequence chunk of the cross-entropy: bounds the transient (B, C, V)
    # float32 logits
    CE_CHUNK = 512

    def __init__(self, cfg: ModelConfig, use_kernels: bool = True,
                 remat: bool = False, perf: PerfFlags = PerfFlags()):
        _check_supported(cfg)
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.remat = remat
        self.perf = perf

    # ------------------------------------------------------------ blocks
    def _ffn(self, spec: BlockSpec, p, x, decode: bool = False):
        """``decode``: the MoE takes its capture-safe form
        (:func:`apply_moe_decode`).  A batch of more tokens than
        ``perf.moe_dropless_max_tokens`` takes the capacity form, and
        ``perf.moe_chunk_tokens`` runs the MoE over token chunks, as the
        reference's ``_moe_dropless`` and ``apply_moe`` (both off in the
        baseline)."""
        f = spec.ffn
        if f.kind == "dense":
            return x + apply_ffn(p["ffn"], rms_norm(x, p["ln2"],
                                                     self.cfg.norm_eps), f)
        if f.kind == "moe":
            h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
            chunk = self.perf.moe_chunk_tokens
            if h.numel() // h.shape[-1] > self.perf.moe_dropless_max_tokens:
                return x + in_token_chunks(apply_moe, p["ffn"], h, f, chunk)
            if decode:
                return x + apply_moe_decode(p["ffn"], h, f)
            return x + in_token_chunks(apply_moe_dropless, p["ffn"], h, f,
                                       chunk)
        return x

    def _train_ffn(self, spec: BlockSpec, p, x, aux):
        """The FFN sub-block in training: a MoE block takes the capacity
        form and adds its load-balance loss to ``aux``.  Returns (x,
        aux)."""
        f = spec.ffn
        if f.kind != "moe":
            return self._ffn(spec, p, x), aux
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        out, a = moe_train(p["ffn"], h, f, self.perf.moe_chunk_tokens)
        return x + out, aux + a

    def _apply_block(self, spec: BlockSpec, p, x, positions, lengths,
                     cache=None, *, causal=True, enc_out=None):
        """Full-sequence block (``cache`` given: a chunk continuing from the
        prior chunks' cache; ``causal=False``: an encoder block; a block
        with a cross sub-block attends over ``enc_out`` after its mixer and
        caches ``{"self", "cross"}``).  Returns (x, cache)."""
        x, c = self._mix(spec, p, x, positions, lengths, cache,
                         causal=causal, enc_out=enc_out)
        return self._ffn(spec, p, x), c

    def _mix(self, spec: BlockSpec, p, x, positions, lengths, cache=None,
             *, causal=True, enc_out=None):
        """The block's mixer and cross sub-blocks, :meth:`_apply_block`
        without the FFN.  Returns (x, cache)."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        m = spec.mixer
        kw = dict(use_kernels=self.use_kernels)
        if isinstance(m, AttentionSpec):
            if cache is None:
                y, c = attn_mod.attention_forward(p["mixer"], h, m,
                                                  positions, causal=causal,
                                                  **kw)
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
        x = x + y
        if spec.cross is not None:
            h = rms_norm(x, p["ln_cross"], self.cfg.norm_eps)
            y, cc = attn_mod.attention_forward(p["cross"], h, spec.cross,
                                               positions, kv_source=enc_out,
                                               **kw)
            x = x + y
            c = {"self": c, "cross": cc}
        return x, c

    def _decode_block(self, spec: BlockSpec, p, x, cache, lengths,
                      tables=None, page_tokens=None, capacity=None):
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        m = spec.mixer
        own = cache["self"] if spec.cross is not None else cache
        if isinstance(m, AttentionSpec) and tables is not None:
            if spec.cross is not None:
                raise ValueError("paged decode does not support "
                                 "cross-attention blocks")
            y, c = attn_mod.attention_decode_paged(
                p["mixer"], h, m, own, lengths, tables,
                page_tokens=page_tokens, capacity=capacity,
                use_kernels=self.use_kernels)
        elif isinstance(m, AttentionSpec):
            y, c = attn_mod.attention_decode(p["mixer"], h, m, own, lengths,
                                             use_kernels=self.use_kernels)
        else:
            y, c = lin_mod.linear_decode(p["mixer"], h, m, own)
        x = x + y
        if spec.cross is not None:
            h = rms_norm(x, p["ln_cross"], self.cfg.norm_eps)
            y, _ = attn_mod.cross_decode(p["cross"], h, spec.cross,
                                         cache["cross"],
                                         use_kernels=self.use_kernels)
            x = x + y
            c = {"self": c, "cross": cache["cross"]}
        return self._ffn(spec, p, x, decode=True), c

    def _run_groups(self, params, x, positions, lengths, caches=None,
                    enc_out=None):
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
                        None if cr is None else cr[key], enc_out=enc_out)
                reps.append(rc)
            out.append(_stack_reps(reps, None if caches is None
                                   else caches[gi]))
        return x, out

    def _train_groups(self, params_groups, x, positions, groups=None,
                      causal=True, enc_out=None, train=True):
        """Every group's repeats in order (``groups``: the decoder's unless
        given), building no caches; each repeat under ``checkpoint`` with
        ``remat``.  The encoder runs through it too (``causal=False``), in
        prefill with ``train=False``.  ``train``: a MoE block takes the
        capacity form and its load-balance losses are summed; otherwise it
        takes the serving path's dropless form.  Returns (x, the summed
        float32 aux loss)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g, gp in zip(groups or self.cfg.groups, params_groups):
            reps = (_unbind_reps(gp["stacked"], g.repeats) if gp["stacked"]
                    else [{}] * g.repeats)

            def body(x, aux, pr, _g=g, _gp=gp):
                for bi, b in enumerate(_g.blocks):
                    key = f"b{bi}"
                    p = _gp["shared"][key] if b.shared else pr[key]
                    x, _ = self._mix(b, p, x, positions, None,
                                     causal=causal, enc_out=enc_out)
                    if train:
                        x, aux = self._train_ffn(b, p, x, aux)
                    else:
                        x = self._ffn(b, p, x)
                return x, aux

            for pr in reps:
                x, aux = (checkpoint(body, x, aux, pr, use_reentrant=False)
                          if self.remat else body(x, aux, pr))
        return x, aux

    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["unembed"]
        return x.float() @ w.float()

    # --------------------------------------------------------------- API
    def train_loss(self, params, batch):
        """batch: {"tokens": (B, S + 1) int}, with "frames" (B, S_enc,
        encoder_input_dim) for an encoder-decoder and "patches" (B, P, d)
        for a VLM.  Mean next-token cross-entropy ``ce`` of ``tokens[:,
        1:]`` given ``tokens[:, :-1]`` (and the frames or patches; patch
        positions have no label), plus the decoder's MoE load-balance
        losses ``aux`` (float32; zero without a MoE block).  Returns
        (ce + AUX_LOSS_WEIGHT * aux / n_layers, {"ce", "aux"}), as the
        reference's ``train_loss`` (``src/repro/models/model.py:371-395``).
        """
        cfg = self.cfg
        dev = params["embed"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        tokens = batch["tokens"].long()
        labels = tokens[:, 1:]
        x, positions, n_prefix = self._decoder_input(
            params, {**batch, "tokens": tokens[:, :-1]})
        enc_out = None
        if cfg.encoder_groups is not None:
            enc_out = self._encode(params, batch["frames"], train=True)
        x, aux = self._train_groups(params["groups"], x, positions,
                                    enc_out=enc_out)
        ce = self._chunked_ce(params, x[:, n_prefix:], labels)
        total = ce + AUX_LOSS_WEIGHT * aux / max(1, cfg.n_layers)
        return total, {"ce": ce, "aux": aux}

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

    def _encode(self, params, frames, train=False):
        """The encoder's output (B, S_enc, d) of ``frames`` (B, S_enc,
        encoder_input_dim): ``enc_proj``, sinusoidal positions, the
        bidirectional encoder groups (``train``: as in training, see
        :meth:`_train_groups`), ``enc_norm``."""
        cfg = self.cfg
        x = frames
        if cfg.encoder_input_dim:
            x = x.to(torch_dtype(cfg)) @ params["enc_proj"]["w"]
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        x, _ = self._train_groups(params["enc_groups"], x, positions,
                                  groups=cfg.encoder_groups, causal=False,
                                  train=train)
        return rms_norm(x, params["enc_norm"], cfg.norm_eps)

    def _decoder_input(self, params, batch):
        """(x (B, S, d), positions, n_prefix): the tokens' embeddings, after
        the projected image patches of a VLM (``n_prefix`` of them), plus
        sinusoidal positions in an encoder-decoder's decoder."""
        cfg = self.cfg
        x = params["embed"][batch["tokens"]]
        n_prefix = 0
        if cfg.num_image_patches:
            patches = (batch["patches"].to(device=x.device, dtype=x.dtype)
                       @ params["patch_proj"]["w"])
            x = torch.cat([patches, x], dim=1)
            n_prefix = patches.shape[1]
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.encoder_groups is not None:
            x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
        return x, positions, n_prefix

    def prefill(self, params, batch):
        """batch: {"tokens": (B, S) int, "lengths": (B,) optional}, with
        "frames" (B, S_enc, encoder_input_dim) for an encoder-decoder and
        "patches" (B, P, d) for a VLM.  Returns (last-token logits (B, V)
        float32, caches).  With ``lengths`` (token counts; a VLM's patches
        come before them) the logits are taken at each row's last token
        and linear-mixer states stop at each row's length, so a
        right-padded batch gives exactly its unpadded results."""
        x, positions, n_prefix = self._decoder_input(params, batch)
        lengths = batch.get("lengths")
        if lengths is not None and n_prefix:
            lengths = lengths + n_prefix
        enc_out = None
        if self.cfg.encoder_groups is not None:
            enc_out = self._encode(params, batch["frames"].to(x.device))
        x, caches = self._run_groups(params, x, positions, lengths,
                                     enc_out=enc_out)
        B = x.shape[0]
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
        require_token_only(self.cfg, "chunked prefill")
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
        page size and the slot capacity.  An encoder-decoder's token takes
        the sinusoidal embedding of its position ``lengths``; a VLM's
        ``lengths`` count its image patches."""
        x = params["embed"][tokens[:, None]]
        if self.cfg.encoder_groups is not None:
            x = x + sinusoidal_positions(lengths.to(x.device)[:, None],
                                         self.cfg.d_model).to(x.dtype)
        x = self._each_block(
            params, x, caches,
            lambda b, p, x, cur: self._decode_block(
                b, p, x, cur, lengths, tables, page_tokens, capacity))
        return self._logits(params, x)[:, 0], caches

    def _each_block(self, params, x, caches, block):
        """Every block invocation in order, ``x, new = block(spec, p, x,
        cache)`` on its repeat's cache views; a leaf ``block`` returns
        anew is copied into the stacked cache.  Returns x."""
        for gi, (g, gp) in enumerate(zip(self.cfg.groups, params["groups"])):
            gc = caches["groups"][gi]
            for r in range(g.repeats):
                pr = _block_params(g, gp, r)
                for bi, b in enumerate(g.blocks):
                    key = f"b{bi}"
                    cur = _rep(gc[key], r)
                    x, new = block(b, pr[key], x, cur)
                    _copy_new(gc[key], cur, new, r)
        return x

    # ------------------------------------------------- speculative verify
    @property
    def _verify_parallel(self) -> bool:
        """Every block append-only full attention with a dense FFN: the
        shape where one pass scores the q positions and nothing needs
        rollback (the reference's ``Model._verify_parallel``)."""
        return all(isinstance(b.mixer, AttentionSpec)
                   and b.mixer.kind == "full" and b.ffn.kind == "dense"
                   for g in self.cfg.groups for b in g.blocks)

    def verify_buffers(self, caches, q: int, batch: int | None = None,
                       paged: bool = False):
        """The buffers a scan verify of ``q`` positions fills, in the
        caches' group structure.  ``snaps``: for every O(1) mixer leaf
        (``state``, ``conv``) a zeroed ``(q - 1, R, B, ...)`` buffer, to
        hold the leaf after each step but the last (the last is the leaf
        itself).  ``rings``: for every sliding-window block, the q rows its
        steps will ring-write, saved before them (``attention.ring_save``:
        (R, B, q, Hkv, D) dense, (R, Hkv, B, q, D) over ``paged`` pools),
        and their addresses.  Other attention leaves need no rollback.
        ``batch``: the slots (read off a dense leaf when not given)."""
        snaps, rings = [], []
        for g, gc in zip(self.cfg.groups, caches["groups"]):
            snaps.append({key: tree_map(
                lambda leaf: torch.zeros((q - 1,) + leaf.shape,
                                         dtype=leaf.dtype,
                                         device=leaf.device),
                _state_leaves(leaves)) for key, leaves in gc.items()})
            ring = {}
            for bi, b in enumerate(g.blocks):
                if not attn_mod.is_ring(b.mixer):
                    continue
                k = gc[f"b{bi}"]["k"]
                B = k.shape[1] if batch is None else batch
                R, Hkv, D = k.shape[0], b.mixer.kv_heads, b.mixer.head_dim
                shape = (R, Hkv, B, q, D) if paged else (R, B, q, Hkv, D)
                ring[f"b{bi}"] = {
                    n: torch.zeros(shape, dtype=k.dtype, device=k.device)
                    for n in ("k", "v")}
                ring[f"b{bi}"]["at"] = torch.zeros(
                    (2, B, q) if paged else (B, q), dtype=torch.long,
                    device=k.device)
            rings.append(ring)
        return {"snaps": snaps, "rings": rings, "paged": paged}

    def decode_verify(self, params, seq, caches, lengths, tables=None,
                      page_tokens=None, capacity=None, pending=None):
        """Score ``q`` candidate positions per slot: ``seq`` (B, q) holds
        each slot's current token, then its drafts.  Returns (logits (B, q,
        V) float32, caches, pending), the caches written in place.

        Dense append-only full attention (:attr:`_verify_parallel`) takes
        one pass over the q positions (:func:`attention.gqa_decode_verify`).
        Everything else (linear and hybrid mixers, MLA, the paged layout)
        runs q steps of the exact :meth:`decode_step`, copying every O(1)
        mixer leaf after each step but the last into ``pending`` (from
        :meth:`verify_buffers`, allocated here when not given), so
        :meth:`commit_verify` can rewind each slot to its accepted step;
        a sliding-window block's ring rows the steps will write are saved
        first.  The other attention leaves need no rollback: a rejected row
        is rewritten before any kept token reads it."""
        require_token_only(self.cfg, "speculative verify")
        q = seq.shape[1]
        if pending is None:
            pending = self.verify_buffers(caches, q, seq.shape[0],
                                          paged=tables is not None)
        if tables is None and self._verify_parallel:
            def block(b, p, x, cur):
                y, new = attn_mod.gqa_decode_verify(
                    p["mixer"], rms_norm(x, p["ln1"], self.cfg.norm_eps),
                    b.mixer, cur, lengths, use_kernels=self.use_kernels)
                return self._ffn(b, p, x + y, decode=True), new

            x = self._each_block(params, params["embed"][seq], caches, block)
            return self._logits(params, x), caches, pending
        for g, gc, rg in zip(self.cfg.groups, caches["groups"],
                             pending["rings"]):
            for key, saved in rg.items():
                attn_mod.ring_save(gc[key], saved, lengths,
                                   g.blocks[int(key[1:])].mixer, tables,
                                   page_tokens=page_tokens,
                                   capacity=capacity)
        logits = []
        for j in range(q):
            lg, caches = self.decode_step(params, seq[:, j], caches,
                                          lengths + j, tables, page_tokens,
                                          capacity)
            logits.append(lg)
            if j < q - 1:
                for gc, sg in zip(caches["groups"], pending["snaps"]):
                    for key, leaves in sg.items():
                        tree_map(lambda buf, cur: buf[j].copy_(cur), leaves,
                                 _state_leaves(gc[key]))
        return torch.stack(logits, dim=1), caches, pending

    def commit_verify(self, caches, pending, accept):
        """Rewind every O(1) mixer leaf, in place, to its state after step
        ``accept[b]`` of the verify that filled ``pending`` (step j is kept
        iff ``j <= accept[b]``), and put back the ring rows of the rejected
        steps of every sliding-window block; with neither (a full-attention
        model) there is nothing to rewind.  (The reference's also takes the
        pre-verify lengths and the tables: here the verify kept the ring
        rows' addresses in ``pending``.)"""
        accept = accept.long()
        for gc, rg in zip(caches["groups"], pending["rings"]):
            for key, saved in rg.items():
                attn_mod.ring_restore(gc[key], saved, accept,
                                      pending["paged"])

        def rewind(snaps, cur):                       # (q - 1, R, B, ...)
            last = snaps.shape[0]                     # q - 1
            B = cur.shape[1]
            got = snaps[torch.clamp(accept, max=last - 1), :,
                        torch.arange(B, device=cur.device)]
            keep = (accept >= last).reshape((1, B) + (1,) * (cur.dim() - 2))
            cur.copy_(torch.where(keep, cur, got.transpose(0, 1)))

        for gc, sg in zip(caches["groups"], pending["snaps"]):
            for key, leaves in sg.items():
                tree_map(rewind, leaves, _state_leaves(gc[key]))
        return caches

    def init_cache(self, batch_size: int, capacity: int, device,
                   enc_len: int = 0):
        """Zeroed decode cache buffers of sequence capacity ``capacity``
        (a cross block's ``"cross"`` leaves hold ``enc_len`` rows)."""
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
                    shape = (R, B, m.kv_cache_tokens(capacity), m.kv_heads,
                             m.head_dim)
                    gc[f"b{bi}"] = {"k": zeros(shape, dt),
                                    "v": zeros(shape, dt)}
                else:
                    gc[f"b{bi}"] = zeros_of(lin_mod.state_shapes(m, B, dt),
                                            (R,), device)
                if b.cross is not None:
                    c = b.cross
                    shape = (R, B, enc_len, c.kv_heads, c.head_dim)
                    gc[f"b{bi}"] = {"self": gc[f"b{bi}"],
                                    "cross": {"k": zeros(shape, dt),
                                              "v": zeros(shape, dt)}}
            groups.append(gc)
        return {"groups": groups}


def zeros_of(shapes, lead, device):
    """Zeroed tensors for a nested {name: (shape, dtype)} dict, each shape
    prefixed by the dims ``lead``."""
    return {n: zeros_of(v, lead, device) if isinstance(v, dict)
            else torch.zeros(tuple(lead) + tuple(v[0]), dtype=v[1],
                             device=device)
            for n, v in shapes.items()}


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
    GQA K/V and MLA latents are zero-padded to capacity, a sliding-window
    block keeps its last ``window`` rows ring-placed at ``pos % window``
    (where the window is below capacity), O(1) states pass through.  A
    cross block's ``"cross"`` leaves keep their encoder length, laid out
    contiguous (R, B, S_enc, Hkv, D) once here, so that every decode step's
    kernel reads them in place."""
    def place(m, c):
        if attn_mod.is_ring(m) and capacity > m.window:
            return {k: attn_mod.ring_place(v, m.window, 2)
                    for k, v in c.items()}
        if isinstance(m, AttentionSpec):
            return {k: _pad_seq(v, capacity) for k, v in c.items()}
        return c

    out = []
    for g, gc in zip(cfg.groups, caches["groups"]):
        placed = {}
        for bi, b in enumerate(g.blocks):
            c = gc[f"b{bi}"]
            if b.cross is not None:
                c = {"self": place(b.mixer, c["self"]),
                     "cross": {k: v.contiguous()
                               for k, v in c["cross"].items()}}
            else:
                c = place(b.mixer, c)
            placed[f"b{bi}"] = c
        out.append(placed)
    return {"groups": out}


def extend_caches(caches, extra: int):
    """Grow the sequence capacity of prefill caches by ``extra`` zero rows
    so decode can append."""
    return tree_map_named(
        lambda name, x: (_pad_seq(x, x.shape[2] + extra)
                         if name in ("k", "v", "ckv", "kpe") else x), caches)
