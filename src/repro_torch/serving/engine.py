"""CachedEngine — the paper's query-handling workflow (§2.5, §2.8) wired
together: embed -> semantic-cache lookup -> hit? serve cached : call LLM
backend -> insert -> respond. PyTorch port of ``repro.serving.engine``.

The engine is batched (the ``Batcher`` groups requests) and keeps its
device state in one ``CacheRuntime`` on an explicit device, with host-side
bookkeeping (detokenization, metrics) in numpy.

Two serve paths (DESIGN.md §7):
  * fused (``use_fused_step=True``, default): a pure *peek* lookup learns
    the miss set, the backend answers the misses, then one
    ``SemanticCache.step`` commits the peek and inserts the misses, over a
    batch padded to the fixed batch size;
  * separate: a counted lookup, then an insert of just the missed rows
    (kept as the reference path).

A ground-truth judge callback replaces the paper's GPT-4o-mini validation:
judge(request, matched_source_id) -> bool; with it, judged hit outcomes feed
the threshold policy (the adaptive controller of paper §2.10).

Index: ``ExactIndex`` by default, or ``IVFIndex`` (k-means buckets, the
repo's analogue of the paper's HNSW), whose state is refit from the slab
with a CPU generator seeded 17 before the first batch and every
``rebuild_every`` inserts after.

Multi-tenancy: constructing the engine with a ``TenantRegistry`` partitions
the slab into per-tenant regions and routes each request's ``tenant``
through the same peek and step: lookups see only their tenant's region,
misses go into their tenant's own ring, and both ``ServingMetrics`` and the
device-side ``TenancyState`` keep per-tenant accounting.

Observability (DESIGN.md §18): ``tracer`` threads per-request stage
spans through ``serve_batch`` (embed, device_step, near_synthesis,
backend_call, insert, respond; each device span ends with the host read
that waits for its work, so the spans tile the wall clock), ``events``
records one structured event per batch with its ``CacheStats`` delta, and
``explain()`` / ``Request.explain`` / ``explain_responses`` attach a
``why`` record, built from host copies taken before the step updates the
slab in place.

A failed backend call marks only its own rows (DESIGN.md §20.2): they get
``Response.error`` and stay out of the slab and every counter, and hit rows
of the same batch are served. Sessions (``fusion``), near-hit synthesis
(``synthesizer``), the rest of resilience (``resilience``: retries, the
breaker, degraded serving) and the sharded cache (``mesh``) arrive with
later slices; each raises NotImplementedError until then. Without them,
responses and ``metrics.summary()`` match the JAX engine's request by
request.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.cache import SemanticCache
from repro_torch.core.runtime import CacheRuntime
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embedding.hash_embedder import HashEmbedder
from repro_torch.obs.explain import build_why, effective_edges
from repro_torch.obs.trace import Tracer
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.training import checkpoint


@dataclasses.dataclass
class Request:
    query: str
    category: str = "default"
    source_id: int = -1          # ground-truth provenance (evaluation only)
    semantic_key: str = ""
    tenant: str = "default"      # isolation domain; ignored without a
                                 # registry
    session: str = ""            # conversation id; "" = stateless request;
                                 # ignored without a fusion strategy
    explain: bool = False        # attach a decision-attribution ``why``
                                 # record to the Response
    deadline_ms: float | None = None
                                 # remaining latency budget in ms; the
                                 # scheduler decrements queue wait before
                                 # dispatch. None = no deadline.


@dataclasses.dataclass
class Response:
    answer: str
    cached: bool
    score: float
    latency_s: float
    coalesced: bool = False   # served by attaching to an in-flight duplicate
                              # (async scheduler)
    context: bool = False     # looked up under a non-empty session window
    near_hit: bool = False    # synthesized from top-k neighbours
    trace_id: str = ""        # RequestTrace id when tracing retained this
                              # request's journey ("" when tracing is off)
    why: dict | None = None   # decision attribution; only set when the
                              # request opted in via Request.explain or the
                              # engine forces explain_responses=True
    degraded: bool = False    # served from a cached neighbour because the
                              # backend was unavailable (resilience slice)
    error: str = ""           # non-empty when this row's backend call
                              # failed; the async scheduler turns it into
                              # a per-row BackendError


#: Row used to right-pad a partial batch up to the engine's fixed batch
#: size. Its empty query embeds to the zero vector (cosine 0 against every
#: slab key — always a miss), and the ``valid`` mask threaded through the
#: fused step keeps pad rows out of counters and the slab.
PAD_REQUEST = Request(query="", category="__pad__", source_id=-1)


class Batcher:
    """Fixed-size batching with padding (sync analogue of a request queue)."""

    def __init__(self, batch_size: int = 32):
        self.batch_size = batch_size

    def batches(self, requests: Sequence[Request]):
        for i in range(0, len(requests), self.batch_size):
            yield list(requests[i:i + self.batch_size])

    def pad(self, batch: list[Request]) -> tuple[list[Request], int]:
        """Right-pad ``batch`` to the fixed batch size. Returns
        ``(padded_batch, n_valid)``; only the first ``n_valid`` rows are
        real."""
        n = len(batch)
        if n >= self.batch_size:
            return list(batch), n
        return list(batch) + [PAD_REQUEST] * (self.batch_size - n), n


_LATER = {
    "fusion": "the sessions slice",
    "synthesizer": "the near-hit slice",
    "resilience": "the resilience slice",
    "mesh": "the sharded-cache slice",
}


class CachedEngine:
    def __init__(self, cache_config: CacheConfig, backend, *,
                 embedder: HashEmbedder | None = None,
                 tokenizer: HashTokenizer | None = None,
                 judge: Callable[[Request, int], bool] | None = None,
                 batch_size: int = 32,
                 policy=None,
                 index=None,
                 rebuild_every: int = 2048,
                 use_fused_step: bool = True,
                 registry=None,
                 fusion=None,
                 synthesizer=None,
                 tracer: Tracer | None = None,
                 events=None,
                 explain_responses: bool = False,
                 resilience=None,
                 mesh=None,
                 device: str | torch.device = "cuda"):
        # ``policy``: optional threshold policy (e.g. AdaptiveThreshold);
        # with a judge, judged hit outcomes are fed back after every batch.
        # ``index``: optional index (e.g. IVFIndex), refit every
        # ``rebuild_every`` inserts (a no-op for the exact index): warm
        # inserts are absorbed into the init centroids, and the first
        # served batch refits, as in the JAX engine. ``registry``: optional
        # TenantRegistry partitioning the slab into per-tenant regions.
        # ``tracer``: optional repro_torch.obs.Tracer; None = a disabled
        # Tracer, whose hooks allocate nothing. ``events``: optional
        # repro_torch.obs.EventLog, one event per serve step.
        # ``explain_responses``: a ``why`` record on every response.
        # ``device``: where the slab lives and the search runs; "cuda"
        # raises when CUDA is absent.
        given = dict(fusion=fusion, synthesizer=synthesizer,
                     resilience=resilience, mesh=mesh)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"CachedEngine({name}=...) arrives with {_LATER[name]}")
        # read by the scheduler, the server and the exporter
        self.synthesizer = None
        self.resilience = None
        self.registry = registry
        partition = None
        if registry is not None:
            partition = registry.partition(cache_config.capacity)
            if min(partition.sizes) < batch_size:
                # the per-tenant ring gives distinct slots only while a
                # batch's rows of a tenant fit inside the tenant's region
                small = partition.names[
                    partition.sizes.index(min(partition.sizes))]
                raise ValueError(
                    f"smallest tenant region ({min(partition.sizes)} slots, "
                    f"tenant {small!r}) is below the batch size "
                    f"({batch_size}); grow the slab or the tenant's "
                    "share/quota")
            self._tenant_index = {n: i for i, n in enumerate(partition.names)}
        elif cache_config.capacity < batch_size:
            raise ValueError(
                f"capacity ({cache_config.capacity} slots) is below the batch "
                f"size ({batch_size}); grow the slab")
        self.device = resolve_device(device)
        self.cache = SemanticCache(cache_config, policy=policy, index=index,
                                   partition=partition)
        self.runtime: CacheRuntime = self.cache.init(self.device)
        self.use_fused_step = use_fused_step
        self.rebuild_every = rebuild_every
        self._inserts_since_rebuild = 0
        self._needs_refit = True
        self._rebuild_rng = torch.Generator().manual_seed(17)
        self.refits = 0          # index refits run by this engine
        self.backend = backend
        self.embedder = embedder or HashEmbedder(dim=cache_config.dim)
        self.tokenizer = tokenizer or HashTokenizer()
        self.judge = judge
        self.batcher = Batcher(batch_size)
        self.metrics = ServingMetrics()
        self.tracer = tracer if tracer is not None else Tracer()
        self.events = events
        self.explain_all = explain_responses
        self._now = 0.0

    # -- runtime views (read-only conveniences) ------------------------- #
    @property
    def state(self):
        return self.runtime.state

    @property
    def stats(self):
        return self.runtime.stats

    @property
    def policy_state(self):
        return self.runtime.policy_state

    def tenant_stats(self) -> dict:
        """Device-side per-tenant accounting (the TenancyState counters),
        keyed by tenant name. Empty on a single-tenant engine."""
        t = self.runtime.tenancy
        if t is None:
            return {}
        t = t.reduced()
        names = ("lookups", "hits", "inserts", "evictions")
        # one device-to-host copy: each copy waits for the device
        cols = dict(zip(names, torch.stack(
            [getattr(t, n) for n in names]).cpu().tolist()))
        part = self.cache.partition
        return {
            name: {
                "lookups": cols["lookups"][i],
                "hits": cols["hits"][i],
                "misses": cols["lookups"][i] - cols["hits"][i],
                "inserts": cols["inserts"][i],
                "evictions": cols["evictions"][i],
                "region_slots": part.sizes[i],
            }
            for i, name in enumerate(part.names)
        }

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(device=self.device,
                                                 dtype=dtype)

    # ------------------------------------------------------------------ #
    def save_cache(self, path: str) -> None:
        """Persist the whole runtime (slab, counters, policy, index and
        tenancy state) in the JAX package's snapshot format. The manifest
        records the partition map, which a restore must match."""
        part = self.cache.partition
        checkpoint.save_checkpoint(
            path, checkpoint.runtime_to_numpy(self.runtime),
            metadata={"now": self._now,
                      "dim": self.cache.config.dim,
                      "capacity": self.cache.config.capacity,
                      "index": type(self.cache.index).__name__,
                      "policy": type(self.cache.policy).__name__,
                      "partition": None if part is None
                      else part.manifest(),
                      "fusion": None,
                      "shard_layout": None})

    def load_cache(self, path: str) -> None:
        """Restore a snapshot taken by this engine or by the JAX one, and
        resume its TTL clock (expiries are absolute deadlines). A snapshot
        taken under another tenant layout is refused: its regions and ring
        pointers would land on the wrong slots."""
        flat = checkpoint.open_checkpoint(path)
        meta = checkpoint.read_metadata(path)
        for key in ("fusion", "shard_layout"):
            if meta.get(key) is not None:
                raise NotImplementedError(
                    f"snapshot {path!r} carries {key} state, which this "
                    "port does not restore yet")
        part = self.cache.partition
        current = None if part is None else part.manifest()
        if meta and meta.get("partition") != current:
            raise ValueError(
                f"snapshot partition map {meta.get('partition')} does not "
                f"match this engine's {current}; rebuild the engine with the "
                "registry the snapshot was taken under")
        restored = checkpoint.runtime_from_numpy(
            flat, self.cache.config, self.device,
            num_tenants=None if part is None else len(part),
            index=self.cache.index)
        want = tuple(self.runtime.policy_state.shape)
        if tuple(restored.policy_state.shape) != want:
            raise ValueError(
                f"snapshot policy state has shape "
                f"{tuple(restored.policy_state.shape)}, this engine's policy "
                f"{type(self.cache.policy).__name__} needs {want}")
        self.runtime = restored
        self._now = float(meta.get("now", self._now))
        self._needs_refit = False
        self._inserts_since_rebuild = 0

    def _maybe_refit(self) -> None:
        if self._needs_refit or \
                self._inserts_since_rebuild >= self.rebuild_every:
            self.runtime = self.cache.refit(self.runtime, self._now,
                                            self._rebuild_rng)
            self.refits += 1
            self._needs_refit = False
            self._inserts_since_rebuild = 0

    def tick(self, seconds: float) -> None:
        """Advance the TTL clock (tests drive expiry deterministically)."""
        self._now += seconds

    def _embed(self, texts) -> torch.Tensor:
        return self._tensor(self.embedder.embed_batch(texts), torch.float32)

    def _tenant_ids(self, batch) -> torch.Tensor | None:
        """(B,) int32 tenant ids of a (possibly padded) batch; None on a
        single-tenant engine. Pad rows route as tenant 0: the ``valid``
        mask keeps them out of every counter and the slab."""
        if self.registry is None:
            return None
        ids = []
        for r in batch:
            if r is PAD_REQUEST:
                ids.append(0)
                continue
            try:
                ids.append(self._tenant_index[r.tenant])
            except KeyError:
                raise KeyError(
                    f"unknown tenant {r.tenant!r}; registered: "
                    f"{tuple(self._tenant_index)}") from None
        return self._tensor(ids, torch.int32)

    def warm(self, pairs, tenant: str | None = None) -> None:
        """Cache population phase (paper §3.1): embed+insert the corpus.

        On a multi-tenant engine the corpus lands in ``tenant``'s region
        (default: the registry's first tenant); warm each tenant
        separately."""
        cfg = self.cache.config
        bs = min(256, cfg.capacity)
        tid_value = None
        if self.registry is not None:
            name = tenant if tenant is not None else self.registry.names[0]
            tid_value = self.registry.index(name)
            # one chunk must fit in the tenant's ring to get distinct slots
            bs = min(bs, self.cache.partition.sizes[tid_value])
        elif tenant is not None:
            raise ValueError("warm(tenant=...) needs a tenant registry")
        for i in range(0, len(pairs), bs):
            chunk = pairs[i:i + bs]
            toks, lens = self.tokenizer.encode_batch(
                [p.answer for p in chunk], cfg.value_len)
            self.runtime = self.cache.insert(
                self.runtime, self._embed([p.question for p in chunk]),
                self._tensor(toks, torch.int32),
                self._tensor(lens, torch.int32), np.float32(self._now),
                source_id=self._tensor([p.qa_id for p in chunk], torch.int32),
                tenant_id=None if tid_value is None else self._tensor(
                    [tid_value] * len(chunk), torch.int32))
            self._inserts_since_rebuild += len(chunk)

    # ------------------------------------------------------------------ #
    def process(self, requests: Sequence[Request]) -> list[Response]:
        out: list[Response] = []
        for batch in self.batcher.batches(requests):
            out.extend(self.serve_batch(batch))
        return out


    def _generate_misses(self, batch, miss_idx):
        """Backend call + tokenizer round-trip for the missed rows.

        Returns (token rows, lens, decoded answers, llm_time, llm_cost).
        Responses are tokenizer-normalized so the hit and miss paths emit
        byte-identical text for the same cache entry.
        """
        cfg = self.cache.config
        res = self.backend.generate(
            [batch[i].query for i in miss_idx],
            [batch[i].semantic_key for i in miss_idx])
        toks, lens = self.tokenizer.encode_batch(
            [res.answers[j] for j in range(len(miss_idx))], cfg.value_len)
        answers = {i: self.tokenizer.decode(toks[j])
                   for j, i in enumerate(miss_idx)}
        return toks, lens, answers, res.latency_s, res.cost_usd

    def _resolve_misses(self, batch, miss_idx):
        """One backend call for the miss rows, its failure contained to
        them (DESIGN.md §20.2). Returns ``(result_tuple, None)`` on success
        or ``(None, err_msg)`` when the call raised: the caller turns
        ``err_msg`` into per-row error responses instead of failing the
        whole batch, and counts the failure."""
        try:
            return self._generate_misses(batch, miss_idx), None
        except Exception as exc:
            self.metrics.resilience_seen = True
            self.metrics.resilience.backend_failures += 1
            return None, f"{type(exc).__name__}: {exc}"

    def _why_snapshot(self, result):
        """Decision-time attribution snapshot: the policy state and the
        top-k neighbours' slots, scores and source ids, copied to the host
        BEFORE the step. The step updates the slab in place and the judged
        feedback replaces the policy state, so a device reference kept
        from here would show the values after the insert, not the ones the
        decision was made under. ``np.array`` copies, also where the
        tensor already lies on the CPU."""
        payload = self.cache.gather_topk(self.runtime, result)
        return (np.array(self.runtime.policy_state.cpu()),
                {"slots": np.array(result.topk_index.cpu()),
                 "scores": np.array(result.topk_score.cpu()),
                 "source_ids": np.array(payload["source_id"].cpu())})

    def _build_whys(self, batch, n_valid, hit, scores, matched_idx,
                    matched_sid, near_row, why_ps, why_topk):
        """Per-row ``why`` records for the rows that opted in."""
        edges_by_tenant: dict = {}
        whys: list = [None] * n_valid
        for i in range(n_valid):
            if not (self.explain_all or batch[i].explain):
                continue
            tix = None if self.registry is None \
                else self._tenant_index[batch[i].tenant]
            if tix not in edges_by_tenant:
                edges_by_tenant[tix] = effective_edges(
                    self.cache.policy, why_ps, self.cache.partition, tix)
            whys[i] = build_why(
                i, request=batch[i], hit=bool(hit[i]), near_served=False,
                score=float(scores[i]), matched_slot=int(matched_idx[i]),
                matched_source_id=int(matched_sid[i]),
                topk_slots=why_topk["slots"][i],
                topk_scores=why_topk["scores"][i],
                topk_source_ids=why_topk["source_ids"][i],
                edges=edges_by_tenant[tix], session_fused=False,
                synthesizer_present=False, near_band=bool(near_row[i]),
                synthesis_source_id=None)
        return whys

    def explain(self, query: str, *, tenant: str = "default",
                session: str = "") -> dict:
        """Offline decision attribution: what WOULD the cache do with
        ``query`` right now, and why? A pure peek: no counter moves,
        nothing is inserted, no backend call is made (``dry_run`` marks
        the record as a what-if)."""
        req = Request(query=query, tenant=tenant, session=session,
                      explain=True)
        batch, _ = self.batcher.pad([req])
        peek, _ = self.cache.lookup(
            self.runtime, self._embed([r.query for r in batch]),
            np.float32(self._now), update_counters=False,
            tenant_id=self._tenant_ids(batch))
        why_ps, why_topk = self._why_snapshot(peek)
        tix = None if self.registry is None else self._tenant_index[tenant]
        why = build_why(
            0, request=req, hit=bool(peek.hit[0]), near_served=False,
            score=float(peek.score[0]), matched_slot=int(peek.index[0]),
            matched_source_id=int(peek.source_id[0]),
            topk_slots=why_topk["slots"][0],
            topk_scores=why_topk["scores"][0],
            topk_source_ids=why_topk["source_ids"][0],
            edges=effective_edges(self.cache.policy, why_ps,
                                  self.cache.partition, tix),
            session_fused=False, synthesizer_present=False,
            near_band=bool(peek.near[0]), synthesis_source_id=None)
        why["dry_run"] = True
        return why

    def serve_batch(self, batch: list[Request], *,
                    record_path_latency: bool = True,
                    traces: list | None = None) -> list[Response]:
        """Serve ONE admission batch: peek -> backend -> fused step commit.

        Both the sync ``process()`` loop and the async scheduler drive it.
        On the fused path a partial batch is right-padded to the fixed
        batch size; the ``valid`` mask keeps pad rows out of every counter,
        the judge, the metrics and the slab. Rows whose backend call failed
        get ``Response.error`` and are kept out the same way.

        ``record_path_latency=False`` skips the per-request hit/miss
        latency samples: the async scheduler records end-to-end (queue
        wait + service) latencies itself.

        ``traces`` is an optional per-row list of ``RequestTrace``s (the
        scheduler passes its entries' traces, already carrying their
        queue-side spans); the engine's stage spans are appended to each
        and the CALLER finishes them. When ``traces`` is None and the
        tracer is collecting, serve_batch starts one trace per real row
        and finishes it with the batch wall time. When tracing is off there
        is no stage clock and no per-request allocation.
        """
        n_valid = len(batch)
        clock = self.tracer.stage_clock()
        own_traces = False
        if clock is not None and traces is None:
            traces = [self.tracer.start() for _ in range(n_valid)]
            own_traces = True
        ev_stats0 = None if self.events is None else self.stats.host()
        if self.registry is not None and len(batch) > self.batcher.batch_size:
            # the per-tenant ring gives distinct slots only for batches up
            # to the batch size the constructor checked against the regions
            raise ValueError(
                f"tenant-partitioned engine got a {len(batch)}-row batch "
                f"but batch_size={self.batcher.batch_size}; align the "
                "scheduler's max_batch with the engine batch size "
                "(AsyncCacheServer's default config does)")
        if self.use_fused_step:
            batch, n_valid = self.batcher.pad(batch)
        cfg = self.cache.config
        n = len(batch)
        tid = self._tenant_ids(batch)
        t0 = time.perf_counter()
        emb = self._embed([r.query for r in batch])
        if clock is not None:
            clock.tick("embed")
        now = np.float32(self._now)
        self._maybe_refit()

        llm_time = 0.0
        llm_cost = 0.0
        answers: dict[int, str] = {}
        failed: dict[int, str] = {}
        want_why = self.explain_all or any(
            batch[i].explain for i in range(n_valid))
        why_ps = why_topk = None

        if self.use_fused_step:
            # 1. pure peek: learn the miss set without committing any state
            #    (the only slab search this batch — step commits it, §7)
            peek, _ = self.cache.lookup(self.runtime, emb, now,
                                        update_counters=False, tenant_id=tid)
            peek_hit = peek.hit.cpu().numpy()   # waits for the search
            cache_time = time.perf_counter() - t0
            if clock is not None:
                clock.tick("device_step")
            if want_why:
                why_ps, why_topk = self._why_snapshot(peek)
            if clock is not None:
                clock.tick("near_synthesis")    # no synthesizer: empty
            miss_idx = [i for i in range(n_valid) if not peek_hit[i]]
            # 2. backend answers the misses (paper §2.5 step 2); a failed
            #    call marks only its own rows
            miss_values = np.zeros((n, cfg.value_len), dtype=np.int32)
            miss_lens = np.zeros((n,), dtype=np.int32)
            if miss_idx:
                out, err = self._resolve_misses(batch, miss_idx)
                if err is None:
                    toks, lens, answers, llm_time, llm_cost = out
                    miss_values[miss_idx] = np.asarray(toks)
                    miss_lens[miss_idx] = np.asarray(lens)
                else:
                    failed = dict.fromkeys(miss_idx, err)
            if clock is not None:
                clock.tick("backend_call")
            # failed rows are never admitted: a cleared valid bit drops
            # them from the insert mask and every counter, like pad rows
            valid = np.zeros((n,), dtype=bool)
            valid[:n_valid] = True
            valid[list(failed)] = False
            # 3. one fused step: commit the peek + masked insert
            t1 = time.perf_counter()
            result, self.runtime = self.cache.step(
                self.runtime, emb, self._tensor(miss_values, torch.int32),
                self._tensor(miss_lens, torch.int32), now,
                source_id=self._tensor([r.source_id for r in batch],
                                       torch.int32),
                peeked=peek, valid=self._tensor(valid, torch.bool),
                tenant_id=tid)
            hit = result.hit.cpu().numpy()   # waits for the step
            cache_time += time.perf_counter() - t1
            if clock is not None:
                clock.tick("insert")
            self._inserts_since_rebuild += len(miss_idx) - len(failed)
        else:
            # reference path: counted lookup, then a subset insert
            result, self.runtime = self.cache.lookup(self.runtime, emb, now,
                                                     tenant_id=tid)
            hit = result.hit.cpu().numpy()
            cache_time = time.perf_counter() - t0
            if clock is not None:
                clock.tick("device_step")
            if want_why:
                why_ps, why_topk = self._why_snapshot(result)
            if clock is not None:
                clock.tick("near_synthesis")
            miss_idx = [i for i in range(n) if not hit[i]]
            out = None
            if miss_idx:
                out, err = self._resolve_misses(batch, miss_idx)
                if err is not None:
                    # the counted lookup above already counted these rows;
                    # they only stay out of the insert (as in the JAX engine)
                    failed = dict.fromkeys(miss_idx, err)
            if clock is not None:
                clock.tick("backend_call")
            if out is not None:
                toks, lens, answers, llm_time, llm_cost = out
                # one subset insert in row order — the same slot order the
                # fused step's masked full-batch insert produces
                idx = torch.as_tensor(miss_idx, device=self.device)
                self.runtime = self.cache.insert(
                    self.runtime, emb[idx], self._tensor(toks, torch.int32),
                    self._tensor(lens, torch.int32), now,
                    source_id=self._tensor(
                        [batch[i].source_id for i in miss_idx], torch.int32),
                    tenant_id=None if tid is None else tid[idx])
                self._inserts_since_rebuild += len(miss_idx)
            if clock is not None:
                clock.tick("insert")

        scores = result.score.cpu().numpy()
        matched_sid = result.source_id.cpu().numpy()

        # hit path: detokenize cached responses (real rows only)
        vals = result.values.cpu().numpy()
        for i in range(n_valid):
            if hit[i]:
                answers[i] = self.tokenizer.decode(vals[i])

        # judge hits (ground-truth oracle replaces GPT-4o-mini); pad rows
        # are never hits (valid-masked), so they contribute no feedback
        positives = np.zeros((n,), dtype=bool)
        if self.judge is not None:
            for i in range(n_valid):
                if hit[i]:
                    positives[i] = self.judge(batch[i], int(matched_sid[i]))
            # adaptive-threshold feedback (paper §2.10)
            self.runtime = self.cache.update_policy(
                self.runtime,
                was_positive=self._tensor(positives & hit, torch.bool),
                was_hit=self._tensor(hit, torch.bool))

        # metrics: baseline = every query pays the LLM call; pad rows and
        # failed rows move no counter (the fault path has its own)
        rows = [i for i in range(n_valid) if i not in failed]
        per_call = getattr(self.backend, "latency_per_call_s", None)
        baseline_time = (per_call or (llm_time / max(len(miss_idx), 1))) \
            * len(rows)
        per_cost = getattr(self.backend, "cost_per_call_usd", 0.0)
        self.metrics.record_batch(
            [batch[i].category for i in rows], hit[rows], positives[rows],
            judged=[self.judge is not None and bool(hit[i]) for i in rows],
            cache_time_s=cache_time, llm_time_s=llm_time,
            llm_cost=llm_cost, baseline_cost=per_cost * len(rows),
            baseline_time=baseline_time,
            tenants=None if self.registry is None else
            [batch[i].tenant for i in rows])

        whys = None
        if want_why:
            whys = self._build_whys(
                batch, n_valid, hit, scores, result.index.cpu().numpy(),
                matched_sid, result.near.cpu().numpy(), why_ps, why_topk)

        per_q_latency = (cache_time + llm_time) / max(n_valid, 1)

        def _path_of(i: int) -> str:
            if i in failed:
                return "error"
            return "hit" if hit[i] else "miss"

        if record_path_latency:
            for i in range(n_valid):
                self.metrics.record_latency(
                    _path_of(i), per_q_latency,
                    tenant=None if self.registry is None else batch[i].tenant)

        def _mk_response(i: int) -> Response:
            tr_id = "" if traces is None or i >= len(traces) \
                else traces[i].trace_id
            w = None if whys is None else whys[i]
            if i in failed:
                return Response(answer="", cached=False,
                                score=float(scores[i]),
                                latency_s=per_q_latency, error=failed[i],
                                trace_id=tr_id, why=w)
            return Response(answer=answers[i], cached=bool(hit[i]),
                            score=float(scores[i]), latency_s=per_q_latency,
                            trace_id=tr_id, why=w)

        responses = [_mk_response(i) for i in range(n_valid)]
        if clock is not None:
            clock.tick("respond")
            if traces is not None:
                # engine spans tile serve_batch's wall time contiguously, so
                # on the sync path span-sum == e2e by construction; the
                # scheduler prepends its queue-side spans and finishes with
                # the true arrival->resolve e2e
                batch_wall = sum(s.duration_s for s in clock.spans)
                for i in range(min(n_valid, len(traces))):
                    tr = traces[i]
                    if not tr:
                        continue
                    tr.spans.extend(clock.spans)
                    tr.annotate(row=i, batch_rows=n_valid,
                                path=_path_of(i))
                    if whys is not None and whys[i] is not None:
                        tr.why = whys[i]
                    if own_traces:
                        self.tracer.finish(tr, e2e_s=batch_wall)
        if self.events is not None:
            stats1 = self.stats.host()
            fault_kw = {} if not failed else {
                "failed": len(failed), "degraded": 0}
            self.events.emit(
                "serve_batch", rows=n_valid,
                hits=int(hit[:n_valid].sum()), near_hits=0,
                backend_calls=len(miss_idx),
                cache_time_s=round(cache_time, 6),
                llm_time_s=round(llm_time, 6),
                stats_delta={k: stats1[k] - ev_stats0[k] for k in ev_stats0},
                **fault_kw)
        return responses
