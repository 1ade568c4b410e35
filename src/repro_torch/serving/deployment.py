"""Multi-region PrfaaS-PD deployment, in-process: the paper's cross-DC
serving loop on the port's engines.

Counterpart of ``src/repro/serving/deployment.py``, greedy, sampled
(``temperature``, ``top_k``, ``sample_seed``) or speculative (``spec_k``,
``spec_ngram``) decode over the dense or the paged KV layout.  A shared PrfaaS ``PrefillEngine`` takes long requests,
each of N PD regions runs its own ``RegionScheduler`` (local prefill on a
shared PD ``PrefillEngine``, its own ``DecodeEngine``).  Routing, prefix
caches, the global KV manager and the inter-DC link topology are the
reference's control-plane code (copied into ``repro_torch.core``):
``Router.route`` picks PrfaaS or the home region per request from the
prefix matches and the link telemetry, and each finished prefill unit
passes through ``_unit_done``, which trims the cache to the prompt or,
for an offloaded request with ``wire_compression`` on, int8-encodes its
K/V/latent leaves for the wire straight from the batch cache (one launch
pair of the quantize kernel on the card), submits the flow on the link,
dequantizes for admission and accounts TTFT.

Device prefix reuse (``paged_kv=True``): each region's ``DecodeEngine``
runs the paged layout over one ``BlockPool`` it shares with the region's
prefix cache.  Prompt pages register at admission (``insert_device``) and
stay LRU-resident after the request retires; ``_route`` pins the pages of
a matching prefix for a request prefilled at home, which then prefills
only its uncached suffix over those pages.  Offloaded prefills ship the
full cache as before and, with wire compression, admit in their int8
form, dequantized inside the page write.

The Router prices prefill with the reference's analytic profile of the
named chip (``chip="h200"`` by default, so routes match the reference), or
with ``calibration`` (a sweep's JSON from
``python -m repro_torch.analysis.calibrate --sweep``) with the measured
``CalibratedProfile`` of the machine that ran the sweep, an H100 on the
card.  ``launch.serve --cross-validate`` prices its simulator replay with
the same profile.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.calibrate import (calibrated_profile,
                                            load_calibration)
from repro_torch.configs.base import AttentionSpec
from repro_torch.core.blockpool import BlockPool
from repro_torch.core.hardware import CHIPS, AnalyticProfile
from repro_torch.core.kv_manager import GlobalKVManager
from repro_torch.core.prefix_cache import HybridPrefixCache
from repro_torch.core.router import (PD, PRFAAS, Router, RouterConfig,
                                     RoutingDecision)
from repro_torch.core.throughput_model import SystemConfig, ThroughputModel
from repro_torch.core.transfer import LinkTopology, star_pairs
from repro_torch.core.workload import Workload
from repro_torch.models import Model
from repro_torch.models.kvcache import (cache_num_bytes,
                                        dequantize_cache_from_wire,
                                        encode_request_for_wire, kv_bytes,
                                        quantize_cache_for_wire)
from repro_torch.models.paged import paged_layout, zero_request_payload
from repro_torch.serving.api import PagePin, Request, Response
from repro_torch.serving.engine import (DecodeEngine, PrefillEngine,
                                        RegionScheduler, trim_request_cache)


@dataclass
class DeploymentConfig:
    threshold: int = 256               # base routing threshold t (tokens)
    link_gbps: float = 1.0             # PrfaaS->region star links
    pd_link_gbps: Optional[Tuple[float, ...]] = None  # per-region override
    pd_mesh_gbps: float = 0.0          # PD<->PD links (0 = star only)
    pd_clusters: int = 1               # regional PD clusters
    decode_slots: int = 8
    capacity: int = 2048               # decode KV capacity per slot
    decode_block_size: int = 8         # tokens per decode block
    min_prefill_bucket: int = 32       # smallest pow2 prefill length bucket
    max_prefill_bucket: Optional[int] = None  # chunked prefill past this
    max_prefill_batch: int = 8         # requests per scheduler prefill unit
    temperature: float = 0.0           # 0 = greedy (bit-identical default)
    top_k: int = 0                     # 0 = full vocab when sampling
    sample_seed: int = 0               # decode sampling noise seed
    spec_k: int = 0                    # speculative draft tokens per round
    spec_ngram: int = 2                # drafter suffix-match length
    tbt_slo_s: float = 0.0             # TBT SLO for attainment (0 = off)
    block_tokens: int = 16
    pool_blocks: int = 4096
    paged_kv: bool = False             # paged device KV + prefix resume
    layerwise_pipeline: bool = True
    wire_compression: bool = False     # int8 KV quantization on the wire
    adapt_thresholds: bool = True      # live per-home congestion feedback
    chip: str = "h200"                 # AnalyticProfile chip for the Router
    chips_per_instance: int = 8
    # path to a sweep's JSON (``analysis.calibrate --sweep``): the Router's
    # profile then derives from that machine's measured kernels instead of
    # the named chip's roofline
    calibration: Optional[str] = None


class CrossDCDeployment:
    def __init__(self, model: Model, params, cfg: DeploymentConfig,
                 router_cfg: Optional[RouterConfig] = None):
        self.model = model
        self.cfg = cfg
        k = cfg.pd_clusters
        if k < 1:
            raise ValueError("pd_clusters must be >= 1")
        self.pd_names = [PD] if k == 1 else [f"pd{i}" for i in range(k)]
        bucket_kw = dict(min_bucket=cfg.min_prefill_bucket,
                         max_bucket=cfg.max_prefill_bucket)
        self.prfaas = PrefillEngine(model, params, **bucket_kw)
        self.pd_prefill = PrefillEngine(model, params, **bucket_kw)
        # a paged region's decode engine (page storage) and prefix cache
        # (page index) share one BlockPool: a cache hit names device pages
        pools: Dict[str, BlockPool] = {}
        if cfg.paged_kv:
            for name in self.pd_names:
                pools[name] = BlockPool(cfg.pool_blocks, cfg.block_tokens,
                                        1 << 16)
        self.decoders: Dict[str, DecodeEngine] = {
            name: DecodeEngine(model, params, cfg.decode_slots, cfg.capacity,
                               block_size=cfg.decode_block_size,
                               temperature=cfg.temperature, top_k=cfg.top_k,
                               seed=cfg.sample_seed, paged=cfg.paged_kv,
                               pool=pools.get(name),
                               page_tokens=cfg.block_tokens,
                               spec_k=cfg.spec_k, spec_ngram=cfg.spec_ngram)
            for name in self.pd_names}
        self.schedulers: Dict[str, RegionScheduler] = {
            name: RegionScheduler(self.pd_prefill, self.decoders[name],
                                  max_prefill_batch=cfg.max_prefill_batch,
                                  on_unit_done=self._unit_done)
            for name in self.pd_names}
        self.caches: Dict[str, HybridPrefixCache] = {PRFAAS: self._new_cache()}
        for name in self.pd_names:
            if cfg.paged_kv:
                self.caches[name] = self._paged_cache(pools[name])
                self._wire_admission(name)
            else:
                self.caches[name] = self._new_cache()
        self.kv = GlobalKVManager()
        for name, cache in self.caches.items():
            self.kv.register_cluster(name, cache)

        # shared control plane: the simulator's Router + link topology
        star = (list(cfg.pd_link_gbps) if cfg.pd_link_gbps is not None
                else [cfg.link_gbps] * k)
        if len(star) != k:
            raise ValueError("pd_link_gbps must have one entry per region")
        if cfg.calibration:
            profile = calibrated_profile(model.cfg,
                                         load_calibration(cfg.calibration),
                                         cfg.chips_per_instance)
        else:
            profile = AnalyticProfile(model.cfg, CHIPS[cfg.chip],
                                      cfg.chips_per_instance)
        self.profile = profile
        self.throughput_model = ThroughputModel(profile, profile, Workload())
        self.system = SystemConfig(1, k, k, sum(star) * 1e9 / 8.0,
                                   float(cfg.threshold))
        self.router = Router(self.throughput_model, self.system, router_cfg)
        pairs = star_pairs(PRFAAS, self.pd_names,
                           mesh=cfg.pd_mesh_gbps > 0 and k > 1)
        gbps = star + [cfg.pd_mesh_gbps] * (len(pairs) - k)
        self.topology = LinkTopology.build([PRFAAS] + self.pd_names, pairs,
                                           gbps)

        self.completed: List[Request] = []
        self.virtual_now = 0.0
        self._wire_raw = 0.0           # raw bytes of caches put on the wire
        self._wire_quant = 0.0         # their measured quantized bytes
        self._seed_ratio = 1.0         # dry-run ratio used before any flow
        if cfg.wire_compression:
            # seed the measured ratio from a one-page dry-run quantization,
            # kept out of the running accumulators
            probe = zero_request_payload(model.cfg, cfg.block_tokens,
                                         device=self.prfaas.device)
            self._seed_ratio = (float(cache_num_bytes(probe))
                                / float(quantize_cache_for_wire(probe)[1]))

    def _new_cache(self) -> HybridPrefixCache:
        return HybridPrefixCache(
            BlockPool(self.cfg.pool_blocks, self.cfg.block_tokens, 1 << 16),
            0, 1)

    def _paged_cache(self, pool: BlockPool) -> HybridPrefixCache:
        """Region prefix cache over the decode engine's page pool: entries
        are registered at admission (``insert_device``) and name live
        device pages, so a match is device-resumable."""
        lay = paged_layout(self.model.cfg, self.cfg.capacity,
                           self.cfg.block_tokens, 1)
        has_state = any(not isinstance(b.mixer, AttentionSpec)
                        for g in self.model.cfg.groups for b in g.blocks)
        return HybridPrefixCache(pool, 0, 1, has_full_attn=lay.seq_cols > 0,
                                 has_linear=lay.ring_cols > 0 or has_state)

    def _wire_admission(self, name: str):
        cache, dec = self.caches[name], self.decoders[name]
        dec.on_admit = lambda req, L, ids, snap: cache.insert_device(
            [int(t) for t in req.tokens], ids, snap)
        # offloaded prefills arriving as int8 wire pytrees admit as wire:
        # the dequantization happens inside the page write
        dec.wire_admission = bool(self.cfg.wire_compression)

    # ------------------------------------------------------------- routing
    def _route(self, req: Request) -> RoutingDecision:
        home = req.home or self.pd_names[0]
        if home not in self.pd_names:
            raise ValueError(f"unknown home region {home!r}; "
                             f"expected one of {self.pd_names}")
        req.home = home
        toks = list(map(int, req.tokens))
        matches = self.kv.match_all(
            toks, names=[n for n in self.caches
                         if self.topology.cache_reachable(home, n,
                                                          hub=PRFAAS)])
        decision = self.router.route(len(toks), matches,
                                     self.topology.pair_signal(PRFAAS, home),
                                     home=home)
        req.decision = decision
        req.route = decision.target
        req.cached_tokens = decision.cached_tokens
        if self.cfg.paged_kv and decision.target == home:
            # local prefill on a paged region: pin the device-resident
            # prefix pages (the references pass to the engine at admission)
            # so only the uncached suffix is computed.  An offloaded
            # prefill cannot use home device pages and ships the full cache.
            c, ids, snap = self.caches[home].match_resume(toks)
            if c:
                self.decoders[home].pool.retain(ids)
                req.device_pin = PagePin(c, ids, snap)
        return decision

    # ------------------------------------------------------------ lifecycle
    def _unit_done(self, engine: PrefillEngine, rs: List[Request], lengths,
                   first, caches, wall: float) -> list:
        """Per-unit accounting the region schedulers call when a prefill
        unit finishes: trim to true lengths (offloaded with wire
        compression: encode in place instead), submit wire flows,
        record prefix-cache entries, compute transfer exposure and TTFT.
        Returns the decode admit entries."""
        self.topology.advance(self.virtual_now)
        flows: Dict[int, list] = {}
        entries = []
        for i, r in enumerate(rs):
            cluster = r.decision.target
            r.prefill_s = wall
            wire = cluster == PRFAAS and self.cfg.wire_compression
            if wire:
                # the quantized pytree is what crosses the link, encoded
                # from the batch cache in place
                payload, nbytes, r.kv_bytes_raw = encode_request_for_wire(
                    caches, i, len(r.tokens))
            else:
                payload = trim_request_cache(caches, i, len(r.tokens))
                r.kv_bytes_raw = cache_num_bytes(payload)
            r.transfer_s = 0.0
            fl = []
            if cluster == PRFAAS:
                if wire:
                    self._wire_raw += r.kv_bytes_raw
                    self._wire_quant += nbytes
                else:
                    nbytes = r.kv_bytes_raw
                r.kv_bytes = nbytes
                start = (self.virtual_now if self.cfg.layerwise_pipeline
                         else self.virtual_now + wall)
                fl.append(("kv", PRFAAS, r.home, self.topology.submit(
                    PRFAAS, r.home, max(float(nbytes), 1.0), start,
                    ramp_end=self.virtual_now + wall)))
            else:
                r.kv_bytes = r.kv_bytes_raw          # intra-cluster RDMA
            d = r.decision
            if d.cross_cache_transfer and d.cached_tokens:
                nb = float(kv_bytes(self.model.cfg, d.cached_tokens))
                if self.cfg.wire_compression:
                    nb /= self.measured_compression()
                nb = max(nb, 1.0)
                r.cross_kv_bytes = nb
                fl.append(("copy", d.cache_cluster, d.target,
                           self.topology.submit(
                               d.cache_cluster, d.target, nb,
                               self.virtual_now,
                               ramp_end=self.virtual_now)))
            flows[r.rid] = fl
            if not (self.cfg.paged_kv and cluster != PRFAAS):
                # paged regions register their device pages at admission
                # (insert_device); metadata-only blocks here would be
                # matched by match_resume as if they held KV
                self.kv.record_prefill(cluster, list(map(int, r.tokens)))
            if (self.cfg.wire_compression and cluster == PRFAAS
                    and not getattr(self.decoders[r.home], "wire_admission",
                                    False)):
                # dense admission takes the dequantized cache; paged homes
                # with wire admission dequantize inside the page write
                payload = dequantize_cache_from_wire(payload)
            entries.append((r, int(first[i]), payload, len(r.tokens)))
        if any(flows.values()):
            self.topology.run_until_idle()
        for r in rs:
            exposure = 0.0
            for kind, a, b, f in flows.get(r.rid, ()):
                tail = 0.0
                if kind == "kv":
                    # the pipelined KV's last layer cannot overlap its own
                    # compute
                    floor = 1.0 / max(1, self.model.cfg.n_layers)
                    tail = f.total_bytes * floor \
                        / self.topology.link(a, b).current_capacity()
                exposed = f.done_time - (self.virtual_now + wall)
                exposure = max(exposure, exposed, tail)
            if flows.get(r.rid):
                r.transfer_s = max(exposure, 0.0)
            r.ttft_s = r.prefill_s + r.transfer_s
        self.virtual_now += wall
        return entries

    def submit_batch(self, reqs: List[Request]) -> Dict[int, Response]:
        """Serve a batch of requests end-to-end; returns responses.
        Requests route first, then the region schedulers tick round-robin
        until every request has retired."""
        for r in reqs:
            decision = self._route(r)
            engine = (self.prfaas if decision.target == PRFAAS
                      else self.pd_prefill)
            self.schedulers[r.home].submit(r, engine)

        scheds = list(self.schedulers.values())
        while any(s.has_work for s in scheds):
            for s in scheds:
                if s.has_work:
                    s.tick()

        if self.cfg.adapt_thresholds:
            for name in self.pd_names:
                self.router.observe_congestion(
                    self.topology.dest_signal(name), home=name)

        out: Dict[int, Response] = {}
        for dec in self.decoders.values():
            out.update(dec.outputs)
        self.completed.extend(reqs)
        return out

    # -------------------------------------------------------------- metrics
    def measured_compression(self) -> float:
        """Running measured raw / quantized byte ratio of the KV put on the
        wire (seeded from a dry-run quantization before the first flow;
        1.0 without compression)."""
        if self._wire_quant > 0:
            return self._wire_raw / self._wire_quant
        return self._seed_ratio

    @staticmethod
    def _tbt_stats(tbt: List[float], slo_s: float) -> dict:
        if not tbt:
            return {"tbt_mean_s": 0.0, "tbt_p50_s": 0.0, "tbt_p90_s": 0.0,
                    "tbt_p99_s": 0.0, "tbt_slo_s": slo_s,
                    "tbt_attainment": 1.0}
        arr = np.asarray(tbt)
        return {
            "tbt_mean_s": float(arr.mean()),
            "tbt_p50_s": float(np.percentile(arr, 50)),
            "tbt_p90_s": float(np.percentile(arr, 90)),
            "tbt_p99_s": float(np.percentile(arr, 99)),
            "tbt_slo_s": slo_s,
            "tbt_attainment": (float((arr <= slo_s).mean())
                               if slo_s > 0 else 1.0),
        }

    def metrics(self) -> dict:
        done = self.completed
        ttft = [r.ttft_s for r in done]
        per_region = {}
        for name in self.pd_names:
            rs = [r for r in done if r.home == name]
            dec = self.decoders[name]
            sched = self.schedulers[name]
            per_region[name] = {
                "requests": len(rs),
                "offloaded": sum(1 for r in rs if r.route == PRFAAS),
                "ttft_mean_s": float(np.mean([r.ttft_s for r in rs]))
                if rs else 0.0,
                "threshold": self.router.threshold_for(name),
                "cache_hit_rate": self.caches[name].hit_rate(),
                "truncations": dec.truncations,
                "occupancy": sched.occupancy(),
                "goodput_tok_s": sched.goodput_tok_s(),
                "max_admit_wait": sched.max_admit_wait,
                "accepted_tokens_per_dispatch":
                    dec.accepted_tokens_per_dispatch,
                **self._tbt_stats(dec.tbt_s, self.cfg.tbt_slo_s),
            }
            if self.cfg.paged_kv:
                pool = dec.pool
                per_region[name]["pool"] = {
                    **pool.stats, "resident": pool.resident,
                    "used_blocks": pool.used_blocks,
                    "num_blocks": pool.num_blocks}
                # device bytes held by LRU-resident prefix pages
                # (reclaimable on demand, reusable on a hit)
                per_region[name]["resident_kv_bytes"] = \
                    pool.resident * dec.page_bytes
                per_region[name]["page_fail_retires"] = dec.page_fail_retires
        busy = sum(d.slot_busy_s for d in self.decoders.values())
        span = sum(self.cfg.decode_slots * s.wall_s
                   for s in self.schedulers.values())
        all_tbt = [t for d in self.decoders.values() for t in d.tbt_s]
        rounds = sum(d.verify_rounds for d in self.decoders.values())
        accepted = sum(d.accepted_tokens for d in self.decoders.values())
        return {
            "requests": len(done),
            "offloaded": sum(1 for r in done if r.route == PRFAAS),
            "ttft_mean_s": float(np.mean(ttft)) if ttft else 0.0,
            "kv_bytes_total": sum(r.kv_bytes for r in done
                                  if r.route == PRFAAS),
            "cache_hit_rate": {k: c.hit_rate()
                               for k, c in self.caches.items()},
            "thresholds": {n: self.router.threshold_for(n)
                           for n in self.pd_names},
            "router_decisions": dict(self.router.decisions),
            "cross_transfers": self.router.cross_transfers,
            "kv_manager": {"rebalanced": self.kv.rebalanced,
                           "cross_transfers": self.kv.cross_transfers,
                           "clusters": self.kv.stats()},
            "paged_kv": self.cfg.paged_kv,
            "truncations": sum(d.truncations for d in self.decoders.values()),
            "occupancy": busy / span if span > 0 else 0.0,
            "goodput_tok_s": sum(s.goodput_tok_s()
                                 for s in self.schedulers.values()),
            "accepted_tokens_per_dispatch": (accepted / rounds if rounds
                                             else 1.0),
            **self._tbt_stats(all_tbt, self.cfg.tbt_slo_s),
            "wire_compression": self.measured_compression(),
            "clusters": per_region,
            "links": self.topology.pair_stats(),
        }
