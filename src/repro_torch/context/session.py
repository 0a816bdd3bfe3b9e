"""SessionStore — host-side conversation state for multi-turn caching
(DESIGN.md §16.1), PyTorch port of ``repro.context.session`` (host numpy,
copied as it is).

The device side (``fusion.py``) pools a ``(B, W, d)`` window of turn
embeddings; this module owns those windows. One store per engine holds a
bounded map of sessions, each a fixed-size ring buffer of the session's
last ``W`` turn embeddings.

What gets appended is the turn's **canonical slab key** — the matched
entry's stored key on a hit, the turn's own fused key on a miss (the very
key the fused step inserted). This is dialogue-state canonicalization: two
conversations that walk the same dialogue path through the cache converge
to *identical* turn windows — the replay's turn hits the recording's
entry, appends that entry's key, and therefore fuses the exact context
the recording fused at the next turn. Appending raw query embeddings
instead would let paraphrase noise compound turn over turn (each turn's
window would differ a little more, and by turn 3 the fused keys drift
below threshold — measured in the sweep that sized the defaults).

Lifecycle:
  * ``window_for`` creates-or-touches a session and returns its current
    window (called before the lookup, so a turn sees only *prior* turns);
  * ``append`` pushes the served turn's raw embedding (called after the
    batch, so two turns of one session in the same batch never see each
    other — callers submit a session's turns sequentially);
  * ``expire`` sweeps TTL-dead sessions. The engine runs it on every
    admission flush (DESIGN.md §16.4), not only on touch, so an abandoned
    session cannot pin its turn window until someone happens to touch it;
  * an LRU cap bounds the total session count: creating session
    ``max_sessions + 1`` evicts the least-recently-touched one.

Privacy/tenancy (MeanCache, arxiv 2403.02694): sessions are namespaced by
``(tenant, session_id)`` — the same wire-level session id under two
tenants is two unrelated sessions, so a session can never read another
tenant's turns. This composes with the slab-level isolation of §13: the
fused key is *built* only from the tenant's own turns and *searched* only
in the tenant's own slab region.

Clock: callers pass ``now`` explicitly (the engine passes its TTL clock,
``tick``-driven in tests) — the store never reads wall time, which keeps
expiry deterministic and testable like the slab's own TTL (§2.7).

Thread-safety: all methods are called from the engine's serve path, which
is single-threaded by construction (sync ``process`` loop, or the async
scheduler's single worker executor).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np


class _Session:
    """One conversation: a (W, d) ring of raw turn embeddings."""

    __slots__ = ("ring", "count", "ptr", "last_touch")

    def __init__(self, window: int, dim: int, now: float):
        self.ring = np.zeros((window, dim), dtype=np.float32)
        self.count = 0          # turns retained (<= window)
        self.ptr = 0            # next write slot
        self.last_touch = now

    def append(self, emb: np.ndarray) -> None:
        self.ring[self.ptr] = emb
        self.ptr = (self.ptr + 1) % self.ring.shape[0]
        self.count = min(self.count + 1, self.ring.shape[0])

    def window(self) -> tuple[np.ndarray, int]:
        """Left-aligned oldest-to-newest copy (the fusion-op layout)."""
        w = self.ring.shape[0]
        out = np.zeros_like(self.ring)
        if self.count == w:
            out[:] = np.roll(self.ring, -self.ptr, axis=0)
        elif self.count:
            out[:self.count] = self.ring[:self.count]
        return out, self.count


class SessionStore:
    """Bounded TTL + LRU map of ``(tenant, session_id) -> turn window``."""

    def __init__(self, *, window: int, dim: int,
                 ttl: float | None = 1800.0, max_sessions: int = 4096):
        if window < 1 or dim < 1:
            raise ValueError("window and dim must be positive")
        if max_sessions < 1:
            raise ValueError("max_sessions must be positive")
        if ttl is not None and ttl <= 0:
            raise ValueError("ttl must be positive (or None to disable)")
        self.window_size = window
        self.dim = dim
        self.ttl = ttl
        self.max_sessions = max_sessions
        # insertion/touch order IS the LRU order (move_to_end on touch)
        self._sessions: "OrderedDict[tuple[str, str], _Session]" \
            = OrderedDict()
        self.created = 0
        self.expired_ttl = 0
        self.evicted_lru = 0

    def __len__(self) -> int:
        return len(self._sessions)

    def _get(self, tenant: str, session: str, now: float) -> _Session:
        key = (tenant, session)
        s = self._sessions.get(key)
        if s is not None and self.ttl is not None \
                and now - s.last_touch > self.ttl:
            # stale hit on touch: the id is reused but the conversation is
            # long over — restart it rather than fuse ancient context
            del self._sessions[key]
            self.expired_ttl += 1
            s = None
        if s is None:
            s = _Session(self.window_size, self.dim, now)
            self._sessions[key] = s
            self.created += 1
            while len(self._sessions) > self.max_sessions:
                self._sessions.popitem(last=False)
                self.evicted_lru += 1
        s.last_touch = now
        self._sessions.move_to_end(key)
        return s

    # -- serve-path API -------------------------------------------------- #
    def window_for(self, tenant: str, session: str, now: float
                   ) -> tuple[np.ndarray, int]:
        """(W, d) left-aligned turn window + turn count; creates/touches."""
        return self._get(tenant, session, now).window()

    def append(self, tenant: str, session: str, emb: np.ndarray,
               now: float) -> None:
        """Push one served turn's raw embedding onto the session's ring."""
        self._get(tenant, session, now).append(
            np.asarray(emb, dtype=np.float32))

    def expire(self, now: float) -> int:
        """TTL sweep (the flush-path hygiene pass, §16.4): drop every
        session idle longer than ``ttl``. Returns the number dropped."""
        if self.ttl is None:
            return 0
        dead = [k for k, s in self._sessions.items()
                if now - s.last_touch > self.ttl]
        for k in dead:
            del self._sessions[k]
        self.expired_ttl += len(dead)
        return len(dead)

    def turns(self, tenant: str, session: str) -> int:
        """Retained turn count (0 if the session does not exist) — a
        read-only probe that neither creates nor touches."""
        s = self._sessions.get((tenant, session))
        return s.count if s is not None else 0

    def stats(self) -> dict:
        return {"sessions": len(self._sessions), "created": self.created,
                "expired_ttl": self.expired_ttl,
                "evicted_lru": self.evicted_lru,
                "window": self.window_size,
                "max_sessions": self.max_sessions}


__all__ = ["SessionStore"]
