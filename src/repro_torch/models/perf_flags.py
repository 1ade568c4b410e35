"""Performance variants: the reference's ``models/perf_flags.py`` and the
launcher knobs of its ``launch/dryrun.py`` in one table.

The reference flips a module-global ``FLAGS`` object; here a variant is a
value.  Its :class:`PerfFlags` go to ``Model(cfg, perf=...)`` and its
placement knobs to the sharding rules, so nothing process-wide changes
what the model computes.  Two flags change the MoE, as in the reference:
  * ``moe_dropless_max_tokens``: an inference batch of more tokens than
    this takes the capacity MoE instead of the exact dropless one
    (``src/repro/models/model.py:169-171``);
  * ``moe_chunk_tokens``: the MoE runs over token chunks of this size, the
    last one zero-padded (``src/repro/models/layers.py:149-176``), so each
    chunk's capacity is that of ``moe_chunk_tokens`` tokens.
The reference's other flags (``shard_moe_tokens``, ``sequence_parallel``,
``shard_attention``) only place activations on a mesh through sharding
constraints; the port runs on plain tensors, so they have no counterpart,
and neither has its ``seqpar`` variant, which adds only one of them to
``moe_shard``.  The defaults are the paper-faithful baseline.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PerfFlags:
    # cap on the token count of the exact dropless MoE; a larger inference
    # batch takes the capacity MoE
    moe_dropless_max_tokens: int = 1 << 62
    # run the MoE over token chunks of this size (0 = off)
    moe_chunk_tokens: int = 0


@dataclass(frozen=True)
class Variant:
    """A dry-run variant: the model's flags and the placement knobs."""
    flags: PerfFlags = field(default_factory=PerfFlags)
    # FSDP: params also sharded over "data"
    fsdp: bool = True
    # decode caches' k / v split over "model" by the head dim where the kv
    # heads do not divide "model"
    shard_headdim: bool = False


_MOE_SHARD = PerfFlags(moe_dropless_max_tokens=32768, moe_chunk_tokens=16384)

VARIANTS = {
    "baseline": Variant(),
    "moe_shard": Variant(_MOE_SHARD),
    "no_fsdp": Variant(_MOE_SHARD, fsdp=False),
    "decode_opt": Variant(fsdp=False, shard_headdim=True),
}
