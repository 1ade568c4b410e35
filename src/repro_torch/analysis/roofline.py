"""Roofline terms of a dry-run cell on the card
(``src/repro/analysis/roofline.py``).

Three terms per (arch x shape x mesh):

    compute    = FLOPs / (gpus * peak FLOP/s)
    memory     = bytes / (gpus * HBM bandwidth)
    collective = collective bytes / (gpus * link bandwidth)

FLOPs and bytes are the whole step's ``meta`` counts
(``analysis/counting.py``).  Collective bytes come from the plan, not from
a compiled program: XLA inserts the collectives the reference reads from
its HLO text, PyTorch inserts none, so :func:`collective_bytes` reckons
them from the sharding rules (``distributed/sharding.py``), one written
rule per case (below), each the per-device result-shape bytes of the
collective, as the reference counts HLO results.

Hardware constants, NVIDIA H100 SXM5 80 GB at 700 W (NVIDIA's H100 data
sheet): 989e12 FLOP/s dense bf16 on the tensor cores, 3.35e12 B/s HBM3.
The link is the per-GPU InfiniBand NDR rate, 400 Gb/s = 50e9 B/s: an
NVLink domain holds 8 GPUs, so neither 16-way axis of the production mesh
fits in one, and the slower link bounds both.

The rules (tokens per device ``T``: the batch over the data axes when it
divides them, times the sequence; one token a row in decode):
  * FSDP all-gather: each leaf sharded over "data" is gathered over
    "data" before use, once a microbatch (twice in training: the remat
    backward gathers it again); result = the leaf over its other axes;
  * FSDP reduce-scatter: in training, each such leaf's gradient, once a
    microbatch; result = the leaf's local shard;
  * data-parallel all-reduce: in training, each gradient over the data
    axes that do not shard its leaf, once a step; result = the local
    shard;
  * TP all-reduce: the output of each row-parallel product (``wo`` of
    every mixer and cross-attention, ``w2`` of every FFN or MoE, the
    vocab-sharded embedding lookup) whose input dim is sharded over
    "model": (T, d) in the activation dtype, three times in training
    (forward, remat recompute, the column-parallel input gradient of the
    backward), once for the embedding;
  * logits all-gather: vocab-sharded unembedding logits (rows, V)
    float32 over "model" (rows: each row's last token in prefill and
    decode; every position twice in training, the chunked cross-entropy
    being recomputed in the backward);
  * decode with a cache sequence-sharded over "data" (batch 1): each
    attention layer's partial outputs and their two softmax statistics,
    (B, H, D + 2) float32, all-reduced over "data" (D: the latent rank
    for MLA).
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field

import torch

from repro_torch.configs.base import AttentionSpec
from repro_torch.distributed import sharding as sh
from repro_torch.models.model import torch_dtype
from repro_torch.models.tree import tree_map_with_path

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 50e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def fsdp_gather_bytes(nbytes: float, spec, sizes: dict) -> float:
    """Result of gathering a leaf of ``spec`` over "data": the leaf over
    its other axes."""
    other = [a for e in spec for a in sh.spec_axes(e) if a != "data"]
    return nbytes / math.prod(sizes[a] for a in other)


def local_shard_bytes(nbytes: float, spec, sizes: dict) -> float:
    """Bytes of a leaf's local shard under ``spec``: the result of its
    gradient's reduce-scatter and of a gradient all-reduce."""
    return nbytes / math.prod(sizes[a] for e in spec
                              for a in sh.spec_axes(e))


def activation_allreduce_bytes(rows: float, width: int,
                               itemsize: int) -> float:
    """Result of all-reducing a (rows, width) partial sum: the TP rule's
    row-parallel outputs, the decode combine's partial outputs."""
    return rows * width * itemsize


def logits_gather_bytes(rows: float, vocab: int) -> float:
    """Result of gathering (rows, vocab) float32 logits over "model"."""
    return rows * vocab * 4


def _data_batch(B: int, sizes: dict) -> int:
    axes = [a for a in ("pod", "data") if a in sizes]
    total = math.prod(sizes[a] for a in axes)
    return B // total if axes and B % total == 0 and B >= total else B


def _model_sharded(spec) -> bool:
    return any("model" in sh.spec_axes(e) for e in spec)


def _invocations(groups, gprefix, p_specs):
    """(block spec, its param specs) for every block invocation of
    ``groups`` (shared blocks once per repeat)."""
    for gi, g in enumerate(groups):
        gs = p_specs[gprefix][gi]
        for _ in range(g.repeats):
            for bi, b in enumerate(g.blocks):
                yield b, gs["shared" if b.shared else "stacked"][f"b{bi}"]


def collective_bytes(cfg, kind: str, B: int, S: int, mesh, *,
                     fsdp: bool = True, mb: int = 1, params=None,
                     shard_headdim: bool = False) -> dict:
    """Per-device collective bytes of one ``kind`` step of ``cfg`` at batch
    ``B``, sequence ``S`` on ``mesh`` by the module's rules, under the
    reference's keys (``count``: the collectives issued)."""
    from repro_torch.launch import input_specs

    sizes = sh.axis_sizes(mesh)
    out = {k: 0.0 for k in COLLECTIVES}
    out["count"] = 0

    def add(k, nbytes, times=1):
        if times and nbytes:
            out[k] += nbytes * times
            out["count"] += times

    if params is None:
        params = input_specs.params_specs(cfg)
    p_specs = sh.params_shardings(params, mesh, fsdp=fsdp)
    train = kind == "train"
    data_axes = [a for a in ("pod", "data") if a in sizes]

    def param_collectives(path, leaf):
        spec = sh.param_pspec(sh.leaf_name(path), tuple(leaf.shape), mesh,
                              fsdp=fsdp)
        nbytes = leaf.numel() * leaf.element_size()
        axes = {a for e in spec for a in sh.spec_axes(e)}
        if "data" in axes:
            add("all-gather", fsdp_gather_bytes(nbytes, spec, sizes),
                mb * (2 if train else 1))
            if train:
                add("reduce-scatter", local_shard_bytes(nbytes, spec, sizes),
                    mb)
        if train and any(a not in axes for a in data_axes):
            add("all-reduce", local_shard_bytes(nbytes, spec, sizes))

    tree_map_with_path(param_collectives, params)

    b_loc = _data_batch(B, sizes)
    ab = torch.empty((), dtype=torch_dtype(cfg)).element_size()
    d = cfg.d_model
    rows = b_loc if kind == "decode" else b_loc * (S + cfg.num_image_patches)
    # per microbatch: each collective is issued mb times over 1/mb of the
    # rows
    n = mb if train else 1
    tp = 3 * n if train else 1
    if _model_sharded(p_specs["embed"]):
        add("all-reduce", activation_allreduce_bytes(rows / n, d, ab), n)
    for blocks, tokens in ((_invocations(cfg.groups, "groups", p_specs),
                            rows),
                           (_invocations(cfg.encoder_groups or (),
                                         "enc_groups", p_specs)
                            if kind != "decode" else (), b_loc * S)):
        for b, ps in blocks:
            for sub in ("mixer", "cross"):
                if sub in ps and "wo" in ps[sub] and \
                        _model_sharded(ps[sub]["wo"]["w"]):
                    add("all-reduce",
                        activation_allreduce_bytes(tokens / n, d, ab), tp)
            if "ffn" in ps and "w2" in ps["ffn"] and \
                    _model_sharded(ps["ffn"]["w2"]):
                add("all-reduce",
                    activation_allreduce_bytes(tokens / n, d, ab), tp)
    unembed = p_specs["embed"] if cfg.tie_embeddings else p_specs["unembed"]
    if _model_sharded(unembed):
        if train:
            add("all-gather",
                logits_gather_bytes(b_loc * S / n, cfg.vocab_size), 2 * n)
        else:
            add("all-gather", logits_gather_bytes(b_loc, cfg.vocab_size))
    if kind == "decode" and B == 1 and "data" in sizes:
        from repro_torch.models import Model
        caches = Model(cfg).init_cache(B, S + 64, torch.device("meta"))
        c_specs = sh.cache_shardings(caches, mesh, shard_seq_over_data=True,
                                     shard_headdim=shard_headdim)
        for gi, g in enumerate(cfg.groups):
            for bi, blk in enumerate(g.blocks):
                m = blk.mixer
                if not isinstance(m, AttentionSpec):
                    continue
                leaf = "ckv" if m.kind == "mla" else "k"
                cs = c_specs["groups"][gi][f"b{bi}"]
                cs = cs["self"] if "self" in cs else cs
                if "data" in sh.spec_axes(cs[leaf][2]):
                    dv = m.mla_kv_rank if m.kind == "mla" else m.head_dim
                    add("all-reduce", activation_allreduce_bytes(
                        B * m.q_heads, dv + 2, 4), g.repeats)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # global quantities
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    model_flops: float
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    useful_flops_frac: float = 0.0
    roofline_frac: float = 0.0
    peak_memory_bytes: float = 0.0
    collective_detail: dict = field(default_factory=dict)

    def finalize(self):
        self.t_compute = self.hlo_flops / (self.chips * PEAK_FLOPS)
        self.t_memory = self.hlo_bytes / (self.chips * HBM_BW)
        self.t_collective = self.coll_bytes / (self.chips * LINK_BW)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        self.useful_flops_frac = (self.model_flops / self.hlo_flops
                                  if self.hlo_flops else 0.0)
        # the ideal time (the useful FLOPs at peak) over the achievable
        # one (the largest term)
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        achievable = max(terms.values())
        self.roofline_frac = ideal / achievable if achievable else 0.0
        return self

    def to_dict(self):
        return asdict(self)


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int,
                    train: bool, *, as_run: bool = False) -> float:
    """MODEL_FLOPS = 6 N_active D (train) or 2 N_active D (forward), the
    reference's convention, in which the input embedding counts as a
    product over every token and so does the unembedding.  ``as_run``:
    the products a decoder's step runs instead, the ones an MFU should
    credit: no input embedding (a lookup does no arithmetic), and the
    unembedding over the rows whose logits are computed (every position
    in training; each row's last token in a prefill; each row in decode).
    Neither counts attention's scores nor a training step's remat
    recompute; both keep the norm scales in N (a few d a layer)."""
    n = cfg.active_param_count()
    tokens = seq_len * global_batch if shape_kind != "decode" else global_batch
    mult = 6.0 if train else 2.0
    if not as_run:
        return mult * n * tokens
    vd = cfg.vocab_size * cfg.d_model
    body = n - (vd if cfg.tie_embeddings else 2 * vd)
    logit_rows = tokens if train else global_batch
    return mult * (body * tokens + vd * logit_rows)


def analyze(arch: str, shape_name: str, mesh_name: str, chips: int,
            counts: dict, coll: dict, cfg, shape, kind: str,
            memory_stats=None) -> RooflineReport:
    """The report of a cell from its whole-step ``counts`` ({"flops",
    "bytes"}, global) and its per-device plan ``coll``; its model FLOPs
    are the step's as run (:func:`model_flops_for`)."""
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(counts["flops"]), hlo_bytes=float(counts["bytes"]),
        coll_bytes=float(coll["total"]) * chips,
        model_flops=model_flops_for(cfg, kind, shape.seq_len,
                                    shape.global_batch, kind == "train",
                                    as_run=True),
        collective_detail=coll,
        peak_memory_bytes=float(memory_stats or 0.0)).finalize()
