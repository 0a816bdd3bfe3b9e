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

Multi-turn sessions (DESIGN.md §16): with a ``ContextFusion`` strategy
the engine keeps a ``SessionStore`` and pools each session row's window of
prior turn keys into its lookup key. The window is built in numpy and moved
to the device once a batch; the key is fused once a batch, and that one
fused key is searched, inserted and appended to the session (the canonical
key: the matched entry's stored key on a hit, the fused key on a miss).
Sessionless and pad rows pass through bit-identically.

Generative near-hits (DESIGN.md §17): with a ``Synthesizer`` (and a band
policy, ``BandPolicy(tau_hi=threshold)`` by default) rows scoring in
[τ_lo, τ_hi) are offered their top-k neighbours (one device-to-host copy a
batch) instead of a backend call. Converted rows are inserted under their
own key with the dominant neighbour's provenance, judged like hits, and
fed back into the band's lower edge.

Resilience (DESIGN.md §20): a failed backend call marks only its own rows:
they get ``Response.error`` and stay out of the slab and every counter, and
hit rows of the same batch are served. With a ``ResilienceConfig`` the miss
path gains deadline budgets, retries with deterministic backoff, a circuit
breaker, and degraded serving of the best cached neighbour above a relaxed
floor (never admitted to the slab, never fed to the threshold or band).
Sharded cache (DESIGN.md §19): with ``mesh`` (``repro_torch.core.
make_mesh``) the cache is a ``DistributedCache`` whose slab is split over
the mesh's ``cache_axes``; every call below goes through the sharded step,
with the same arguments, so nothing else here changes. Regions and the
batch size are checked per shard, ``warm`` chunks fit a shard's ring, and
snapshots record the shard layout: ``load_cache`` restores a snapshot of
another shard count by re-placing its entries (``reshard=True``) or
refuses it. Responses and ``metrics.summary()`` match the JAX engine's
request by request.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.context.session import SessionStore
from repro_torch.core.cache import SemanticCache
from repro_torch.core.distributed import DistributedCache, shard_axes
from repro_torch.core.runtime import CacheRuntime, ShardedRuntime
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embedding.hash_embedder import HashEmbedder
from repro_torch.generative.policy import BandPolicy
from repro_torch.generative.synthesize import Neighbour
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
    degraded: bool = False    # served from the best cached neighbour under
                              # the relaxed degraded floor because the
                              # backend was unavailable or the budget spent;
                              # never admitted to the slab
    error: str = ""           # non-empty when this row's backend call
                              # failed and no degraded answer was servable;
                              # the async scheduler turns it into a per-row
                              # BackendError


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
                 session_ttl_s: float | None = 1800.0,
                 max_sessions: int = 4096,
                 synthesizer=None,
                 tracer: Tracer | None = None,
                 events=None,
                 explain_responses: bool = False,
                 resilience=None,
                 mesh=None,
                 cache_axes: tuple[str, ...] = ("data",),
                 device: str | torch.device | None = None):
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
        # ``fusion``: optional ContextFusion strategy; attaches a
        # SessionStore (TTL ``session_ttl_s`` on the engine's tick clock,
        # LRU-capped at ``max_sessions``). ``synthesizer``: optional
        # near-hit Synthesizer; without a ``policy`` the policy becomes
        # BandPolicy(tau_hi=threshold). ``resilience``: optional
        # ResilienceConfig (retries, breaker, degraded serving); None = one
        # backend attempt whose failure marks only its own rows.
        # ``mesh``: optional ShardMesh (``make_mesh``); the slab is split
        # over its ``cache_axes`` in a DistributedCache, each shard on its
        # mesh device. None = one shard. ``device``: where the slab lives
        # and the search runs; None means CUDA, which raises when CUDA is
        # absent. With a mesh it is the mesh's controller (shard 0's
        # device), where queries arrive and results leave: None means
        # that device, and another is refused.
        if synthesizer is not None and policy is None:
            policy = BandPolicy(tau_hi=cache_config.threshold)
        # read by the scheduler, the server and the exporter
        self.synthesizer = synthesizer
        self.resilience = resilience
        self.registry = registry
        self.mesh = mesh
        self._num_shards = 1 if mesh is None \
            else shard_axes(mesh, tuple(cache_axes))
        shards = self._num_shards
        partition = None
        if registry is not None:
            partition = registry.partition(cache_config.capacity)
            if min(partition.sizes) // shards < batch_size:
                # the per-tenant ring gives distinct slots only while a
                # batch's rows of a tenant fit inside the tenant's region,
                # on a mesh inside each shard's slice of it
                small = partition.names[
                    partition.sizes.index(min(partition.sizes))]
                raise ValueError(
                    f"smallest tenant region ({min(partition.sizes)} slots "
                    f"/ {shards} shard(s), tenant {small!r}) is below the "
                    f"batch size ({batch_size}); grow the slab or the "
                    "tenant's share/quota")
            self._tenant_index = {n: i for i, n in enumerate(partition.names)}
        elif cache_config.capacity // shards < batch_size:
            raise ValueError(
                f"per-shard capacity ({cache_config.capacity} slots / "
                f"{shards} shard(s)) is below the batch size "
                f"({batch_size}); grow the slab or shrink the mesh")
        self.device = mesh.device if mesh is not None and device is None \
            else resolve_device(device)
        self.cache = SemanticCache(cache_config, policy=policy, index=index,
                                   partition=partition, fusion=fusion)
        if mesh is not None:
            # its init refuses a device other than the mesh's controller
            self.cache = DistributedCache(self.cache, mesh,
                                          cache_axes=tuple(cache_axes))
        self.fusion = fusion
        self.sessions = None
        if fusion is not None:
            self.sessions = SessionStore(
                window=fusion.window, dim=cache_config.dim,
                ttl=session_ttl_s, max_sessions=max_sessions)
        self.runtime: CacheRuntime | ShardedRuntime = self.cache.init(
            self.device)
        # int8 slab keys dequantize by a device-tensor divisor: CUDA turns a
        # division by a Python scalar into a reciprocal multiply
        self._int8_unit = torch.full((), 127.0, device=self.device)
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
        """Persist the whole runtime (slab, counters, policy, index, tenancy
        and fusion state) in the JAX package's snapshot format. The manifest
        records the partition map, which a restore must match, and the
        shard layout (None unsharded), which a restore re-places entries
        across."""
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
                      "fusion": None if self.fusion is None
                      else type(self.fusion).__name__,
                      "shard_layout": None if self.mesh is None
                      else self.cache.shard_layout()})

    def load_cache(self, path: str, *, reshard: bool = True) -> None:
        """Restore a snapshot taken by this engine or by the JAX one, and
        resume its TTL clock (expiries are absolute deadlines). A snapshot
        taken under another tenant layout is refused: its regions and ring
        pointers would land on the wrong slots. A snapshot with fusion
        weights needs a fusion engine; a snapshot without them loads into a
        fusion engine, which keeps its fresh fusion weights (raw
        single-turn keys still match bit-identically).

        Shard layouts (DESIGN.md §19.5): a snapshot of this engine's shard
        count loads strictly, index state included. One of another shard
        count is refused under ``reshard=False``; otherwise its live
        entries are re-placed into this layout's rings on the host
        (``checkpoint.reshard_runtime``) and the index is refit before the
        next batch (the saved buckets hold the old placement's slots)."""
        flat = checkpoint.load_checkpoint_flat(path)
        meta = checkpoint.read_metadata(path)
        if self.fusion is None and any(k.startswith("runtime/fusion/")
                                       for k in flat):
            raise ValueError(
                f"snapshot {path!r} carries context-fusion weights "
                "(runtime/fusion/*) but this engine has no fusion strategy; "
                "construct the engine with fusion=... to load it")
        part = self.cache.partition
        current = None if part is None else part.manifest()
        if meta and meta.get("partition") != current:
            raise ValueError(
                f"snapshot partition map {meta.get('partition')} does not "
                f"match this engine's {current}; rebuild the engine with the "
                "registry the snapshot was taken under")
        layout = meta.get("shard_layout")
        saved_shards = 1 if layout is None else int(layout["num_shards"])
        if saved_shards != self._num_shards:
            if not reshard:
                raise ValueError(
                    f"snapshot {path!r} was taken on {saved_shards} "
                    f"shard(s) but this engine runs {self._num_shards}; "
                    "pass reshard=True to re-place the entries on load")
            restored = checkpoint.reshard_runtime(
                flat, self.cache.init(self.device), old_shards=saved_shards,
                new_shards=self._num_shards, partition=part)
            needs_refit = True
        else:
            restored = checkpoint.runtime_from_numpy(
                flat, self.cache.config, self.device,
                num_tenants=None if part is None else len(part),
                index=self.cache.index, fused=self.fusion is not None,
                num_shards=None if self.mesh is None else self._num_shards)
            needs_refit = False
        if restored.fusion is None and self.runtime.fusion is not None:
            restored = restored.replace(fusion=self.runtime.fusion)
        want = tuple(self.runtime.policy_state.shape)
        if tuple(restored.policy_state.shape) != want:
            raise ValueError(
                f"snapshot policy state has shape "
                f"{tuple(restored.policy_state.shape)}, this engine's policy "
                f"{type(self.cache.policy).__name__} needs {want}")
        if self.mesh is not None:
            restored = self.cache.place(restored)
        self.runtime = restored
        self._now = float(meta.get("now", self._now))
        self._needs_refit = needs_refit
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
        # one chunk must fit in the (per-shard slice of the) ring it goes
        # to, or written and parked rows could share a slot
        bs = min(256, cfg.capacity // self._num_shards)
        tid_value = None
        if self.registry is not None:
            name = tenant if tenant is not None else self.registry.names[0]
            tid_value = self.registry.index(name)
            bs = min(bs, self.cache.partition.sizes[tid_value]
                     // self._num_shards)
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

    # -- sessions ------------------------------------------------------- #
    def _session_windows(self, batch):
        """Per-row session turn windows of a (possibly padded) batch.

        Returns ``(window (B, W, d), window_len (B,), has_ctx)`` on the
        engine's device, built in numpy and moved once; or
        ``(None, None, [False]*B)`` on a fusion-less engine. Sessionless
        and pad rows get a zero window of length 0, which the fusion op
        passes through bit-identically."""
        if self.sessions is None:
            return None, None, [False] * len(batch)
        win = np.zeros((len(batch), self.sessions.window_size,
                        self.sessions.dim), dtype=np.float32)
        wlen = np.zeros((len(batch),), dtype=np.int32)
        for i, r in enumerate(batch):
            if r is PAD_REQUEST or not r.session:
                continue
            win[i], wlen[i] = self.sessions.window_for(r.tenant, r.session,
                                                        self._now)
        return (self._tensor(win, torch.float32),
                self._tensor(wlen, torch.int32), [bool(c) for c in wlen])

    def _canonical_keys(self, result, keys: torch.Tensor) -> np.ndarray:
        """(B, d) canonical slab key per row (§16.1), in one device-to-host
        copy: the matched entry's stored key on a hit, the row's own fused
        key ``keys`` (the very key the step inserted) on a miss. Read after
        the step, as the reference does. Appending these, not raw
        embeddings, makes two conversations in the same dialogue state
        converge to identical turn windows."""
        matched = self.cache.slab_rows(self.runtime, "keys", result.index)
        int8 = matched.dtype == torch.int8
        matched = matched.to(torch.float32)
        if int8:
            matched = matched / self._int8_unit   # symmetric unit-row quant
        return torch.where(result.hit[:, None], matched,
                           keys).cpu().numpy()

    def _append_turns(self, batch, n_valid: int, keys_np: np.ndarray,
                      skip=()) -> None:
        """Push each served session row's canonical turn key, after the
        batch, so a turn never fuses into its own lookup. ``skip`` holds the
        failed and degraded rows: they were not answered from the slab, so
        their keys must not advance the session window."""
        for i in range(n_valid):
            r = batch[i]
            if r.session and i not in skip:
                self.sessions.append(r.tenant, r.session, keys_np[i],
                                     self._now)

    # -- the miss path -------------------------------------------------- #
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

    def _split_expired(self, batch, miss_idx):
        """Split the miss set into rows whose deadline budget is already
        spent (straight to degraded serving) and rows still worth a backend
        call. No-op without a resilience config."""
        if self.resilience is None:
            return {}, list(miss_idx)
        failed: dict[int, str] = {}
        gen_idx: list[int] = []
        for i in miss_idx:
            d = batch[i].deadline_ms
            if d is not None and d <= 0.0:
                self.metrics.resilience.deadline_exhausted += 1
                failed[i] = ("DeadlineExhausted: budget spent before the "
                             "backend call")
            else:
                gen_idx.append(i)
        return failed, gen_idx

    def _resolve_misses(self, batch, miss_idx):
        """One backend resolution for the miss rows: containment + retries.

        Returns ``(result_tuple, None)`` on success or ``(None, err_msg)``;
        the caller turns ``err_msg`` into per-row degraded or error
        responses instead of failing the whole batch. With a resilience
        config the call is gated by the circuit breaker and retried under
        the backoff and deadline-budget rules; without one it is a single
        attempt whose failure is still contained to its own rows."""
        r = self.resilience
        rm = self.metrics.resilience
        if r is None:
            try:
                return self._generate_misses(batch, miss_idx), None
            except Exception as exc:
                self.metrics.resilience_seen = True
                rm.backend_failures += 1
                return None, f"{type(exc).__name__}: {exc}"
        budget_s = None
        deadlines = [batch[i].deadline_ms for i in miss_idx
                     if batch[i].deadline_ms is not None]
        if deadlines:
            # one call serves every miss row, so the tightest row's budget
            # bounds the retry schedule of the whole set
            budget_s = min(deadlines) / 1000.0
        key = batch[miss_idx[0]].query
        start = r.clock()
        attempt = 0
        while True:
            if r.breaker is not None and not r.breaker.allow():
                rm.breaker_short_circuits += 1
                return None, ("BreakerOpen: circuit breaker is open; "
                              "backend call short-circuited")
            attempt += 1
            try:
                out = self._generate_misses(batch, miss_idx)
            except Exception as exc:
                if r.breaker is not None:
                    r.breaker.record_failure()
                rm.backend_failures += 1
                delay = r.retry.backoff_s(attempt, key=key)
                elapsed = r.clock() - start
                if not r.retry.allows(attempt, elapsed_s=elapsed,
                                      next_backoff_s=delay,
                                      budget_s=budget_s):
                    if (budget_s is not None
                            and attempt < r.retry.max_attempts):
                        rm.deadline_exhausted += 1
                    return None, f"{type(exc).__name__}: {exc}"
                rm.retries += 1
                r.sleep(delay)
                continue
            if r.breaker is not None:
                r.breaker.record_success()
            if attempt > 1:
                rm.retry_successes += 1
            return out, None

    def _degraded_floor(self) -> float:
        """Relaxed score floor for degraded serving: the config's
        ``degraded_band_lo`` wins, else the band policy's ``degraded_lo``,
        else 0.55."""
        r = self.resilience
        if r is not None and r.degraded_band_lo is not None:
            return float(r.degraded_band_lo)
        dl = getattr(self.cache.policy, "degraded_lo", None)
        return 0.55 if dl is None else float(dl)

    def _neighbours(self, payload: dict, i: int, cols) -> list[Neighbour]:
        return [Neighbour(slot=int(payload["slot"][i, j]),
                          score=float(payload["score"][i, j]),
                          source_id=int(payload["source_id"][i, j]),
                          answer=self.tokenizer.decode(payload["values"][i, j]))
                for j in cols]

    def _serve_degraded(self, batch, failed, payload):
        """Degraded-mode serving (§20.4): each failed miss row is offered
        the best cached neighbour at or above the relaxed degraded floor —
        synthesis first when a synthesizer is installed, else the dominant
        neighbour's stored answer verbatim. Returns row -> (answer, score,
        source_id). ``payload()`` gives the top-k neighbours on the host.
        Served rows stay out of the slab (the caller clears their ``valid``
        bits): a degraded answer is another entry's answer under the wrong
        key."""
        r = self.resilience
        if r is None or not r.degraded_serving or not failed:
            return {}
        floor = self._degraded_floor()
        rm = self.metrics.resilience
        nb = payload()
        out: dict[int, tuple[str, float, int]] = {}
        for i in sorted(failed):
            cand = [j for j in range(nb["slot"].shape[1])
                    if nb["slot"][i, j] >= 0 and nb["score"][i, j] >= floor]
            if not cand:
                rm.degraded_failed += 1
                continue
            served = None
            if self.synthesizer is not None:
                syn = self.synthesizer.synthesize(
                    batch[i].query, self._neighbours(nb, i, cand))
                if syn is not None:
                    served = (syn.answer, float(nb["score"][i, cand[0]]),
                              int(syn.source_id))
            if served is None:
                j = cand[0]      # neighbours arrive score-descending
                served = (self.tokenizer.decode(nb["values"][i, j]),
                          float(nb["score"][i, j]),
                          int(nb["source_id"][i, j]))
            out[i] = served
            rm.degraded_served += 1
        return out

    # -- near hits ------------------------------------------------------ #
    def _topk_payload(self, result) -> dict[str, np.ndarray]:
        """The top-k neighbours of every row on the host — slots, scores
        (-inf where none), source ids and cached answers — in one
        device-to-host copy. Taken before the step, which updates the slab
        in place."""
        p = self.cache.gather_topk(self.runtime, result)
        vlen = p["values"].shape[-1]
        packed = torch.cat(
            [p["values"], p["source_id"][..., None],
             result.topk_index.to(torch.int32)[..., None],
             p["score"].view(torch.int32)[..., None]], dim=-1).cpu().numpy()
        return {"values": packed[..., :vlen],
                "source_id": packed[..., vlen],
                "slot": packed[..., vlen + 1],
                "score": np.ascontiguousarray(
                    packed[..., vlen + 2]).view(np.float32)}

    def _synthesize_near(self, batch, n_valid: int, near: np.ndarray,
                         payload):
        """Host-side near-hit synthesis (§17.3), shared by both serve paths.

        Every band row ([τ_lo, τ_hi) score) is offered its visible top-k
        neighbours (``payload()``). Returns ``(syn_by_row, syn_time,
        syn_cost)``: row -> ``Synthesis`` for the rows converted; abstained
        rows fall back to the backend call like any miss."""
        if self.synthesizer is None or not near[:n_valid].any():
            return {}, 0.0, 0.0
        nb = payload()
        syn_by_row: dict[int, object] = {}
        syn_time = syn_cost = 0.0
        for i in range(n_valid):
            if not near[i]:
                continue
            cols = [j for j in range(nb["slot"].shape[1])
                    if nb["slot"][i, j] >= 0]
            syn = self.synthesizer.synthesize(
                batch[i].query, self._neighbours(nb, i, cols))
            if syn is not None:
                syn_by_row[i] = syn
                syn_time += syn.latency_s
                syn_cost += syn.cost_usd
        return syn_by_row, syn_time, syn_cost

    # -- attribution ---------------------------------------------------- #
    def _why_snapshot(self, payload):
        """Decision-time attribution snapshot: the policy state and the
        top-k neighbours' slots, scores and source ids, on the host BEFORE
        the step. The step updates the slab in place and the judged
        feedback replaces the policy state, so a device reference kept from
        here would show the values after the insert."""
        nb = payload()
        return (np.array(self.runtime.policy_state.cpu()),
                {"slots": nb["slot"], "scores": nb["score"],
                 "source_ids": nb["source_id"]})

    def _build_whys(self, batch, n_valid, hit, near_served, scores,
                    matched_idx, matched_sid, near_row, has_ctx,
                    syn_by_row, why_ps, why_topk):
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
                i, request=batch[i], hit=bool(hit[i]),
                near_served=bool(near_served[i]), score=float(scores[i]),
                matched_slot=int(matched_idx[i]),
                matched_source_id=int(matched_sid[i]),
                topk_slots=why_topk["slots"][i],
                topk_scores=why_topk["scores"][i],
                topk_source_ids=why_topk["source_ids"][i],
                edges=edges_by_tenant[tix],
                session_fused=bool(has_ctx[i]),
                synthesizer_present=self.synthesizer is not None,
                near_band=bool(near_row[i]),
                synthesis_source_id=(syn_by_row[i].source_id
                                     if i in syn_by_row else None))
        return whys

    def explain(self, query: str, *, tenant: str = "default",
                session: str = "") -> dict:
        """Offline decision attribution: what WOULD the cache do with
        ``query`` right now, and why? A pure peek: no counter moves,
        nothing is inserted, no synthesis or backend call is made
        (``in_band`` tells the near-hit story; ``dry_run`` marks the record
        as a what-if). A ``session`` is looked up under its turn window,
        as the reference does (which creates or touches the session)."""
        req = Request(query=query, tenant=tenant, session=session,
                      explain=True)
        batch, _ = self.batcher.pad([req])
        win, wlen, has_ctx = self._session_windows(batch)
        peek, _ = self.cache.lookup(
            self.runtime, self._embed([r.query for r in batch]),
            np.float32(self._now), update_counters=False,
            tenant_id=self._tenant_ids(batch), window=win, window_len=wlen)
        why_ps, why_topk = self._why_snapshot(
            lambda: self._topk_payload(peek))
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
            session_fused=has_ctx[0], synthesizer_present=False,
            near_band=bool(peek.near[0]), synthesis_source_id=None)
        why["dry_run"] = True
        return why

    # -- the serve path ------------------------------------------------- #
    def serve_batch(self, batch: list[Request], *,
                    record_path_latency: bool = True,
                    traces: list | None = None) -> list[Response]:
        """Serve ONE admission batch: peek -> backend -> fused step commit.

        Both the sync ``process()`` loop and the async scheduler drive it.
        On the fused path a partial batch is right-padded to the fixed
        batch size; the ``valid`` mask keeps pad rows out of every counter,
        the judge, the metrics and the slab. Rows whose backend call failed
        (and degraded rows) are kept out the same way.

        ``record_path_latency=False`` skips the per-request path latency
        samples: the async scheduler records end-to-end (queue wait +
        service) latencies itself.

        ``traces`` is an optional per-row list of ``RequestTrace``s (the
        scheduler passes its entries' traces, already carrying their
        queue-side spans); the engine's stage spans are appended to each
        and the CALLER finishes them. When ``traces`` is None and the
        tracer is collecting, serve_batch starts one trace per real row
        and finishes it with the batch wall time. When tracing is off there
        is no stage clock and no per-request allocation.
        """
        n_valid = len(batch)
        if self.resilience is not None:
            # the resilience section shows in summaries before any fault
            # (callers replace engine.metrics, so not in __init__)
            self.metrics.resilience_seen = True
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
        if self.sessions is not None:
            # TTL sweep on every batch: an abandoned session dies on the
            # next admission, not only when it is touched again
            self.sessions.expire(self._now)
        t0 = time.perf_counter()
        emb = self._embed([r.query for r in batch])
        win, wlen, has_ctx = self._session_windows(batch)
        if clock is not None:
            clock.tick("embed")
        now = np.float32(self._now)
        self._maybe_refit()
        # the one fused key of this batch: searched, inserted and appended
        keys = self.cache._maybe_fuse(self.runtime, emb, win, wlen)

        llm_time = 0.0
        llm_cost = 0.0
        answers: dict[int, str] = {}
        want_why = self.explain_all or any(
            batch[i].explain for i in range(n_valid))
        why_ps = why_topk = None
        # the neighbours' one host copy, taken on first use and shared by
        # attribution, synthesis and degraded serving; the slab does not
        # change between the search and the step
        payload = functools.cache(lambda: self._topk_payload(looked_up))

        if self.use_fused_step:
            # 1. pure peek: learn the miss set without committing any state
            #    (the only slab search this batch — step commits it, §7)
            looked_up, _ = self.cache.lookup(self.runtime, keys, now,
                                             update_counters=False,
                                             tenant_id=tid)
            # one copy; waits for the search
            peek_hit, peek_near = torch.stack(
                [looked_up.hit, looked_up.near]).cpu().numpy()
            cache_time = time.perf_counter() - t0
            if clock is not None:
                clock.tick("device_step")
            if want_why:
                why_ps, why_topk = self._why_snapshot(payload)
            # 1b. near-hit synthesis: band rows the synthesizer converts
            #     skip the backend; abstained rows stay misses
            syn_by_row, syn_time, syn_cost = self._synthesize_near(
                batch, n_valid, peek_near, payload)
            if clock is not None:
                clock.tick("near_synthesis")
            miss_idx = [i for i in range(n_valid)
                        if not peek_hit[i] and i not in syn_by_row]
            # 2. backend answers the misses (paper §2.5 step 2); a failed
            #    call marks only its own rows, which fall to degraded
            #    serving or an error row
            miss_values = np.zeros((n, cfg.value_len), dtype=np.int32)
            miss_lens = np.zeros((n,), dtype=np.int32)
            failed, gen_idx = self._split_expired(batch, miss_idx)
            if gen_idx:
                out, err = self._resolve_misses(batch, gen_idx)
                if err is None:
                    toks, lens, answers, llm_time, llm_cost = out
                    miss_values[gen_idx] = np.asarray(toks)
                    miss_lens[gen_idx] = np.asarray(lens)
                else:
                    failed.update(dict.fromkeys(gen_idx, err))
            degraded = self._serve_degraded(batch, failed, payload)
            if clock is not None:
                clock.tick("backend_call")
            # synthesized rows ride the same masked insert (the insert mask
            # is ~hit, band rows included): the near-hit answer goes in
            # under the query's own key with the dominant neighbour's
            # source_id as provenance
            sid_np = np.asarray([r.source_id for r in batch], dtype=np.int32)
            if syn_by_row:
                rows = sorted(syn_by_row)
                stoks, slens = self.tokenizer.encode_batch(
                    [syn_by_row[i].answer for i in rows], cfg.value_len)
                miss_values[rows] = np.asarray(stoks)
                miss_lens[rows] = np.asarray(slens)
                for j, i in enumerate(rows):
                    answers[i] = self.tokenizer.decode(stoks[j])
                    sid_np[i] = syn_by_row[i].source_id
            # failed and degraded rows are never admitted: a cleared valid
            # bit drops them from the insert mask and every counter, like
            # pad rows
            valid = np.zeros((n,), dtype=bool)
            valid[:n_valid] = True
            valid[list(failed)] = False
            # 3. one fused step: commit the peek + masked insert
            t1 = time.perf_counter()
            result, self.runtime = self.cache.step(
                self.runtime, keys, self._tensor(miss_values, torch.int32),
                self._tensor(miss_lens, torch.int32), now,
                source_id=self._tensor(sid_np, torch.int32),
                peeked=looked_up, valid=self._tensor(valid, torch.bool),
                tenant_id=tid)
            # one copy; waits for the step
            hit, near_row = torch.stack(
                [result.hit, result.near]).cpu().numpy()
            cache_time += time.perf_counter() - t1
            if clock is not None:
                clock.tick("insert")
            self._inserts_since_rebuild += \
                len(miss_idx) - len(failed) + len(syn_by_row)
        else:
            # reference path: counted lookup, then a subset insert of the
            # same fused keys
            looked_up, self.runtime = self.cache.lookup(
                self.runtime, keys, now, tenant_id=tid)
            result = looked_up
            hit, near_row = torch.stack(
                [result.hit, result.near]).cpu().numpy()
            cache_time = time.perf_counter() - t0
            if clock is not None:
                clock.tick("device_step")
            if want_why:
                why_ps, why_topk = self._why_snapshot(payload)
            syn_by_row, syn_time, syn_cost = self._synthesize_near(
                batch, n, near_row, payload)
            if clock is not None:
                clock.tick("near_synthesis")
            miss_idx = [i for i in range(n)
                        if not hit[i] and i not in syn_by_row]
            # per-row insert payload: backend answers for misses, admitted
            # syntheses for converted band rows
            row_toks: dict[int, np.ndarray] = {}
            row_lens: dict[int, int] = {}
            row_sid: dict[int, int] = {}
            failed, gen_idx = self._split_expired(batch, miss_idx)
            if gen_idx:
                out, err = self._resolve_misses(batch, gen_idx)
                if err is None:
                    toks, lens, answers, llm_time, llm_cost = out
                    for j, i in enumerate(gen_idx):
                        row_toks[i] = np.asarray(toks[j])
                        row_lens[i] = int(lens[j])
                        row_sid[i] = batch[i].source_id
                else:
                    # the counted lookup above already counted these rows;
                    # they only stay out of the insert (as in the JAX engine)
                    failed.update(dict.fromkeys(gen_idx, err))
            degraded = self._serve_degraded(batch, failed, payload)
            if clock is not None:
                clock.tick("backend_call")
            if syn_by_row:
                rows = sorted(syn_by_row)
                stoks, slens = self.tokenizer.encode_batch(
                    [syn_by_row[i].answer for i in rows], cfg.value_len)
                for j, i in enumerate(rows):
                    row_toks[i] = np.asarray(stoks[j])
                    row_lens[i] = int(slens[j])
                    row_sid[i] = syn_by_row[i].source_id
                    answers[i] = self.tokenizer.decode(np.asarray(stoks[j]))
            # one subset insert in row order — the same slot order the
            # fused step's masked full-batch insert produces
            ins = sorted(row_toks)
            if ins:
                idx = torch.as_tensor(ins, device=self.device)
                self.runtime = self.cache.insert(
                    self.runtime, keys[idx],
                    self._tensor(np.stack([row_toks[i] for i in ins]),
                                 torch.int32),
                    self._tensor([row_lens[i] for i in ins], torch.int32),
                    now,
                    source_id=self._tensor([row_sid[i] for i in ins],
                                           torch.int32),
                    tenant_id=None if tid is None else tid[idx])
                self._inserts_since_rebuild += len(ins)
            if clock is not None:
                clock.tick("insert")

        if self.sessions is not None:
            self._append_turns(batch, n_valid,
                               self._canonical_keys(result, keys),
                               skip=failed)

        scores = result.score.cpu().numpy()
        matched_sid = result.source_id.cpu().numpy()
        near_served = np.zeros((n,), dtype=bool)
        near_served[list(syn_by_row)] = True

        # hit path: detokenize cached responses (real rows only)
        vals = result.values.cpu().numpy()
        for i in range(n_valid):
            if hit[i]:
                answers[i] = self.tokenizer.decode(vals[i])

        # judge hits (ground-truth oracle replaces GPT-4o-mini); pad rows
        # are never hits (valid-masked), so they contribute no feedback.
        # Synthesized near-hits are judged against their synthesis
        # provenance, the dominant neighbour's source_id
        positives = np.zeros((n,), dtype=bool)
        if self.judge is not None:
            for i in range(n_valid):
                if hit[i]:
                    positives[i] = self.judge(batch[i], int(matched_sid[i]))
                elif near_served[i]:
                    positives[i] = self.judge(
                        batch[i], int(syn_by_row[i].source_id))
            # one host-to-device copy of the feedback masks
            fb = self._tensor(np.stack([positives & hit, hit, positives,
                                        near_served]), torch.bool)
            # adaptive-threshold feedback (paper §2.10)
            self.runtime = self.cache.update_policy(
                self.runtime, was_positive=fb[0], was_hit=fb[1])
            if self.synthesizer is not None:
                # judged near-hit outcomes nudge the band's lower edge
                self.runtime = self.cache.update_band(
                    self.runtime, was_positive=fb[2], was_near=fb[3])
        if self.judge is not None and degraded:
            # degraded answers are judged for observation only: an outage
            # must not move the edges the healthy path serves under
            rm = self.metrics.resilience
            for i, d in degraded.items():
                rm.degraded_judged += 1
                if self.judge(batch[i], int(d[2])):
                    rm.degraded_positives += 1

        # metrics: baseline = every query pays the LLM call; pad rows and
        # failed or degraded rows move no counter (the fault path has its
        # own)
        ok_rows = [i for i in range(n_valid) if i not in failed]
        per_call = getattr(self.backend, "latency_per_call_s", None)
        baseline_time = (per_call or (llm_time / max(len(miss_idx), 1))) \
            * len(ok_rows)
        per_cost = getattr(self.backend, "cost_per_call_usd", 0.0)
        self.metrics.record_batch(
            [batch[i].category for i in ok_rows],
            hit[ok_rows], positives[ok_rows],
            judged=[self.judge is not None
                    and (bool(hit[i]) or bool(near_served[i]))
                    for i in ok_rows],
            cache_time_s=cache_time, llm_time_s=llm_time + syn_time,
            llm_cost=llm_cost + syn_cost,
            baseline_cost=per_cost * len(ok_rows),
            baseline_time=baseline_time,
            tenants=None if self.registry is None else
            [batch[i].tenant for i in ok_rows],
            contexts=None if self.sessions is None else
            [has_ctx[i] for i in ok_rows],
            nears=None if self.synthesizer is None else near_row[ok_rows],
            near_served=None if self.synthesizer is None
            else near_served[ok_rows],
            syn_cost=syn_cost, syn_time=syn_time)

        whys = None
        if want_why:
            whys = self._build_whys(
                batch, n_valid, hit, near_served, scores,
                result.index.cpu().numpy(), matched_sid, near_row, has_ctx,
                syn_by_row, why_ps, why_topk)

        per_q_latency = (cache_time + llm_time + syn_time) / max(n_valid, 1)

        def _path_of(i: int) -> str:
            if i in degraded:
                return "degraded"
            if i in failed:
                return "error"
            if hit[i]:
                return "hit"
            return "near" if near_served[i] else "miss"

        if record_path_latency:
            for i in range(n_valid):
                self.metrics.record_latency(
                    _path_of(i), per_q_latency,
                    tenant=None if self.registry is None else batch[i].tenant)

        def _mk_response(i: int) -> Response:
            tr_id = "" if traces is None or i >= len(traces) \
                else traces[i].trace_id
            w = None if whys is None else whys[i]
            if i in degraded:
                ans, sc, _sid = degraded[i]
                return Response(answer=ans, cached=False, score=sc,
                                latency_s=per_q_latency, context=has_ctx[i],
                                degraded=True, trace_id=tr_id, why=w)
            if i in failed:
                return Response(answer="", cached=False,
                                score=float(scores[i]),
                                latency_s=per_q_latency, context=has_ctx[i],
                                error=failed[i], trace_id=tr_id, why=w)
            return Response(answer=answers[i], cached=bool(hit[i]),
                            score=float(scores[i]), latency_s=per_q_latency,
                            context=has_ctx[i],
                            near_hit=bool(near_served[i]),
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
                "failed": len(failed), "degraded": len(degraded)}
            self.events.emit(
                "serve_batch", rows=n_valid,
                hits=int(hit[:n_valid].sum()),
                near_hits=len(syn_by_row),
                backend_calls=len(miss_idx),
                cache_time_s=round(cache_time, 6),
                llm_time_s=round(llm_time + syn_time, 6),
                stats_delta={k: stats1[k] - ev_stats0[k] for k in ev_stats0},
                **fault_kw)
        return responses
