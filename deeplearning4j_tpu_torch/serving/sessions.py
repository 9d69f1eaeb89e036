"""Sticky sessions: pin a finished request's KV pages for its next turn.

Counterpart of ``deeplearning4j_tpu/serving/sessions.py``, the same
host-side table without the telemetry gauges and flight-recorder events
of the JAX package.

A multi-turn conversation replays its whole history to a stateless
engine every turn; the prefix cache (prefix_cache.py) recovers the
full-page part of that, but the conversation's OWN tail — its last
partial page, its generated tokens — is better than cacheable: it is
known to belong to exactly one client. A sticky session keeps it:

- on finish, a request submitted with a ``session_id`` PINS its pages
  (trimmed to the committed positions) together with the committed
  token history instead of freeing them;
- the next ``submit()`` with the same id whose prompt EXTENDS that
  history resumes decode after prefilling only the new tokens —
  mid-page, via the engine's suffix-prefill program — with zero
  re-prefill of the history;
- a prompt that contradicts the history releases the session and falls
  back to the prefix cache (full history pages were inserted there at
  the first turn, so even the fallback stays warm).

Eviction: TTL (``ttl`` seconds since last use), capacity (oldest
session evicted when ``capacity`` is exceeded), explicit
``release(session_id)``, and — because pinned pages must never starve
live traffic — the engine's admission path evicts the oldest session
when the pool cannot otherwise satisfy a request. Pages are released
through ``PagePool.free`` (refcount decrement), so history pages also
indexed by the prefix cache survive the session's death.

All mutation happens on the engine's scheduler thread except
``release``/``stats`` (client-callable); one lock guards the table.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np



class Session:
    """One pinned conversation: committed token history (prompt +
    generated tokens whose K/V landed in the pool) and the pages
    holding positions ``[0, pos)``."""

    __slots__ = ("session_id", "pages", "tokens", "pos", "created",
                 "last_used", "turns")

    def __init__(self, session_id: str, pages: List[int],
                 tokens: np.ndarray, now: float, turns: int = 1):
        self.session_id = session_id
        self.pages = pages
        self.tokens = tokens
        self.pos = int(tokens.size)
        self.created = now
        self.last_used = now
        self.turns = int(turns)   # finished turns pinned under this id


class SessionStore:
    """TTL + capacity bounded table of pinned sessions."""

    def __init__(self, capacity: int, ttl: float):
        if capacity < 1:
            raise ValueError(f"session capacity must be >= 1, got "
                             f"{capacity}")
        self.capacity = int(capacity)
        self.ttl = float(ttl)
        self._sessions: "Dict[str, Session]" = {}
        self._lock = threading.Lock()
        self.pinned = 0
        self.resumed = 0
        self.expired = 0
        self.released = 0

    # ------------------------------------------------------------ stats
    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)

    def pinned_pages(self) -> int:
        with self._lock:
            return sum(len(s.pages) for s in self._sessions.values())

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "sessions": len(self._sessions),
                "pinned_pages": sum(len(s.pages)
                                    for s in self._sessions.values()),
                "pinned_total": self.pinned,
                "resumed_total": self.resumed,
                "expired_total": self.expired,
                "released_total": self.released,
            }

    # ------------------------------------------------------------- pin
    def pin(self, session_id: str, pages: List[int],
            tokens: np.ndarray, pool, turns: int = 1) -> None:
        """Pin a finished request's committed state. Re-pinning an id
        replaces (and frees) the previous pin; past ``capacity`` the
        LEAST-RECENTLY-USED session is evicted."""
        now = time.monotonic()
        with self._lock:
            old = self._sessions.pop(session_id, None)
            if old is not None:
                pool.free(old.pages)
            while len(self._sessions) >= self.capacity:
                lru = min(self._sessions.values(),
                          key=lambda s: s.last_used)
                self._evict_locked(lru, pool)
            self._sessions[session_id] = Session(
                session_id, list(pages), np.asarray(tokens, np.int32),
                now, turns=turns)
            self.pinned += 1

    def peek(self, session_id: str):
        """(pages copy, pos, turns) without removing — the admission
        planner sizes its allocation BEFORE committing to take()."""
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                return None
            return list(s.pages), s.pos, s.turns

    # ----------------------------------------------------------- resume
    def match_pos(self, session_id: str, prompt: np.ndarray) \
            -> Optional[int]:
        """Committed position count if ``prompt`` extends the pinned
        history (resume possible), else None. Read-only — the budget
        hint and the admission planner both use it."""
        with self._lock:
            s = self._sessions.get(session_id)
            if s is None:
                return None
            prompt = np.asarray(prompt, np.int32)
            if prompt.size < s.pos \
                    or not np.array_equal(prompt[:s.pos], s.tokens):
                return None
            return s.pos

    def pages_hint(self, session_id: str) -> int:
        with self._lock:
            s = self._sessions.get(session_id)
            return len(s.pages) if s is not None else 0

    def take(self, session_id: str) -> Optional[Session]:
        """Remove and return the session — its pages (and their
        references) now belong to the caller's slot. ``last_used`` is
        refreshed so a re-pin keeps its LRU position."""
        with self._lock:
            s = self._sessions.pop(session_id, None)
            if s is not None:
                s.last_used = time.monotonic()
                self.resumed += 1
        return s

    # --------------------------------------------------------- eviction
    def release(self, session_id: str, pool) -> bool:
        """Explicit client release: free the pinned pages now."""
        with self._lock:
            s = self._sessions.pop(session_id, None)
            if s is None:
                return False
            self._free_locked(s, pool)
            self.released += 1
        return True

    def expire(self, pool, now: Optional[float] = None) -> int:
        """TTL sweep: evict every session idle past ``ttl``."""
        now = time.monotonic() if now is None else now
        n = 0
        with self._lock:
            for s in [s for s in self._sessions.values()
                      if now - s.last_used > self.ttl]:
                del self._sessions[s.session_id]
                self._evict_locked(s, pool, pop=False)
                n += 1
        return n

    def evict_oldest(self, pool) -> int:
        """Admission-pressure valve: drop the least-recently-used
        session so a live request can allocate. Returns pages freed."""
        with self._lock:
            if not self._sessions:
                return 0
            lru = min(self._sessions.values(),
                      key=lambda s: s.last_used)
            del self._sessions[lru.session_id]
            freed = len(lru.pages)
            self._evict_locked(lru, pool, pop=False)
        return freed

    def clear(self, pool) -> int:
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
            for s in sessions:
                self._free_locked(s, pool)
        return len(sessions)

    def _evict_locked(self, s: Session, pool, pop: bool = True) -> None:
        """TTL, capacity or pressure eviction (counted as expired)."""
        if pop:
            self._sessions.pop(s.session_id, None)
        self._free_locked(s, pool)
        self.expired += 1

    @staticmethod
    def _free_locked(s: Session, pool) -> None:
        if s.pages:
            pool.free(s.pages)
        s.pages = []


__all__ = ["Session", "SessionStore"]
