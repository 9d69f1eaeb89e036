"""Continuous-batching decode engine over the port's ``CausalLM``.

Counterpart of ``deeplearning4j_tpu/serving/engine.py``:

- **Slot-based fixed-shape decode step.** A static batch of ``slots``
  decode lanes; each slot carries its own KV pages, position and
  sampling state. A finished request's slot is refilled from the queue
  between bursts while its neighbours keep decoding.
- **Paged KV cache** (kv_pages.py): one page pool allocated at startup,
  per-slot page tables, refcounted pages. ``kv_dtype="fp8_e4m3"``
  stores the pages as fp8 with per-page-per-head scales, half the
  bytes of a bf16 page.
- **Bucketed prefill**: a cold prompt is padded to the smallest prefill
  bucket that holds it and run through one batched forward
  (:func:`prefill_forward`); its K/V is committed into its pages and the
  first token is picked from the last real position.
- **Cross-request KV reuse** (``prefix_cache=True``,
  ``session_capacity > 0``): the prefix cache (prefix_cache.py) maps a
  prompt's cached full pages straight into the new slot's table (copy-
  on-write for a page that diverges mid-way), and a sticky session
  (sessions.py) pins a finished conversation's pages for its next turn.
  Either way only the new tokens are prefilled, by the SUFFIX prefill
  (:meth:`DecodeEngine._prefix_prefill`), which attends through the
  slot's whole page table at query positions ``t_start ..``.
- **Speculative decoding** (``spec_decode=k``, spec_decode.py): a host
  draft proposes up to ``k`` tokens per slot, one verify pass
  (:meth:`DecodeEngine._verify`) scores all ``k + 1`` positions of every
  slot, and the accepted prefix plus a correction token is emitted.
- **int8 decode weights** (``quantization="int8"``): the decode step
  and the verify pass read int8 matmul weights with per-channel f32
  scales (nn/precision.py); the prefills keep the float weights.
- **Chunked bursts**: decode steps run back to back with no host sync
  until the roster can change — the nearest request completion, one
  chunk when any active request has an ``eos_id``, or a queued request
  that could join a free slot — and the burst's tokens come to the host
  in one copy.
- **Cancellation**: ``ServingRequest.cancel()`` from any thread; the
  scheduler frees the slot and its pages at its next pass.

Every attention of the engine — the decode step (Q=1), the suffix
prefill (N=1, Q = the suffix bucket) and the verify pass (Q = k + 1) —
goes through ``ops/paged_attention.py``: the hand-written CUDA kernel on
the card, the plain PyTorch reference on the CPU. Each appends its
positions' K/V to the pools before it attends, as the JAX engine does.

Greedy parity contract (tested at f32): every request decoded through
the engine produces the same tokens as the JAX engine with the same
options, and, without int8 or fp8, as a solo ``CausalLM.generate()``
call. Sampling draws Gumbel noise from one ``torch.Generator`` per
request, seeded from ``sample_seed`` or from the engine seed and the
request's ordinal, so a request's samples do not depend on what else is
in flight; they are not the JAX engine's draws.

Not ported here (later slices): the fleet's prefill-lane handoff
(``handoff_threshold``, ``warm_source``, ``submit_prepared`` raise),
telemetry, tracing and the flight recorder. The JAX engine's
ahead-of-time warm pool has no counterpart: PyTorch runs eagerly.
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue as _queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.gpt import gumbel_noise
from deeplearning4j_tpu_torch.nn.precision import (int8_matmul,
                                                   quantize_int8,
                                                   resolve_kv_dtype)
from deeplearning4j_tpu_torch.params import tree_map
from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention
from deeplearning4j_tpu_torch.serving import kv_pages
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.sessions import SessionStore
from deeplearning4j_tpu_torch.serving.spec_decode import (SpecConfig,
                                                          accept_tokens)

log = logging.getLogger("deeplearning4j_tpu_torch")

#: process-wide request ids
_REQUEST_IDS = itertools.count()
#: process-wide engine ordinals (engine ids in logs and stats)
_ENGINE_IDS = itertools.count()

_FLEET = ("is the serving fleet's prefill-lane handoff, not ported yet "
          "(ROADMAP A7.6)")


class CapacityRejected(RuntimeError):
    """The admission queue is full."""


class ServingRequest:
    """Handle for one submitted generation request.

    ``result()`` blocks until completion and returns the generated
    tokens (np.int32, length <= max_new_tokens — shorter on EOS or
    cancellation). ``stream()`` yields tokens as the engine emits them.
    ``ttft_s`` / ``latency_s`` are filled in as the request progresses."""

    def __init__(self, request_id: int, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float,
                 eos_id: Optional[int], generator: torch.Generator,
                 session_id: Optional[str] = None):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.generator = generator
        self.session_id = session_id
        #: prompt tokens whose K/V came from the prefix cache or a
        #: sticky session instead of prefill compute (0 = cold)
        self.cache_hit_tokens = 0
        #: speculative decoding: per-request opt-out (None follows the
        #: engine) and the request's own draft tally
        self.spec_enabled: Optional[bool] = None
        self.spec_proposed = 0
        self.spec_accepted = 0
        #: conversation turn this request will pin as (resume bumps it)
        self._session_turns = 1
        #: the engine serving this request: what routes ``cancel()``
        self._engine: Optional["DecodeEngine"] = None
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None  # length|eos|cancelled|error
        self.ttft_s: Optional[float] = None
        self.latency_s: Optional[float] = None
        self._t_submit = time.perf_counter()
        self._stream: "_queue.Queue" = _queue.Queue()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None

    # -- engine side ----------------------------------------------------
    def _push(self, token: int) -> None:
        if self.ttft_s is None:
            self.ttft_s = time.perf_counter() - self._t_submit
        self.tokens.append(token)
        self._stream.put(token)

    def _finish(self, reason: str,
                error: Optional[BaseException] = None) -> None:
        self.finish_reason = reason
        self._error = error
        self.latency_s = time.perf_counter() - self._t_submit
        self._stream.put(None)            # stream sentinel
        self._done.set()

    # -- client side ----------------------------------------------------
    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return np.asarray(self.tokens, np.int32)

    def cancel(self) -> bool:
        """Abort this request from any thread: queued, it never runs;
        decoding, its slot is freed and its pages drain back to the pool
        at the scheduler's next pass. It finishes with
        ``finish_reason="cancelled"`` and ``result()`` returns the
        tokens generated so far. False when it had already finished."""
        eng = self._engine
        if eng is None:
            return False
        return eng.abort(self)

    def stream(self):
        """Yield tokens as they are generated; raises the request's
        error (if any) after the stream ends."""
        while True:
            tok = self._stream.get()
            if tok is None:
                break
            yield tok
        if self._error is not None:
            raise self._error


def prefill_forward(model, params, prompt, t0: int):
    """One batched forward over the padded ``[1, B]`` prompt (positions
    >= t0 are causally invisible to the real ones): the per-layer K/V
    stacks and the last REAL position's logits."""
    logits, ks, vs = model.forward(params, prompt, return_kv=True)
    return ks, vs, logits[0, t0 - 1]


class DecodeEngine:
    """Continuous-batching generation server over a CausalLM.

    Parameters
    ----------
    model, params : the CausalLM and its parameter tree (torch tensors
        in the JAX layout, e.g. from ``params_from_jax``). The engine
        keeps its own copy on ``device``, cast to the compute dtype.
    slots : decode-batch width (requests in flight per step).
    page_size : KV-cache page length in positions.
    max_context : per-request position budget (prompt + generated);
        defaults to (and is capped at) ``model.cfg.max_len``.
    n_pages : total KV pool pages (incl. the null page). Default sizes
        the pool so every slot can hold ``max_context`` positions.
    prefill_buckets : prompt padding widths; default powers of two
        (times page_size) up to max_context.
    quantization : None | "int8" — int8 weight-only decode weights
        (per-channel scales, dequantized in the matmul); the prefills
        keep the float weights.
    kv_dtype : None | "fp8_e4m3" — fp8 KV pages with per-page-per-head
        f32 scales, quantized on commit and dequantized in attention.
    prefix_cache : index committed prompt pages and serve later prompts'
        shared prefixes from the same refcounted pages.
    session_capacity / session_ttl : > 0 enables sticky sessions: a
        finished ``session_id`` request pins its pages and history for
        its next turn (LRU over ``session_capacity``, ``session_ttl``
        seconds idle, ``release_session``, admission pressure).
    spec_decode : None | int k | "ngram" | dict | SpecConfig —
        speculative decoding; requests opt out per submit with
        ``spec_decode=False``.
    max_chunk : upper bound (a power of two) on decode steps per chunk;
        a burst chains up to ``MAX_BURST_CHUNKS`` chunks.
    device : where the engine runs; default the CUDA card. With no card
        and no ``device``, construction raises.
    handoff_threshold, warm_source : the fleet's options; not ported,
        they raise ``NotImplementedError``.
    """

    #: chunks chained per burst before tokens are fetched and emitted
    #: (bounds streaming latency)
    MAX_BURST_CHUNKS = 4

    def __init__(self, model, params, *, slots: int = 8,
                 page_size: int = 16, max_context: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 quantization: Optional[str] = None,
                 max_chunk: int = 8, max_queue: int = 512, seed: int = 0,
                 prefix_cache: bool = False, session_capacity: int = 0,
                 session_ttl: float = 600.0,
                 kv_dtype: Optional[str] = None, spec_decode=None,
                 device=None, handoff_threshold: Optional[int] = None,
                 warm_source: Optional["DecodeEngine"] = None):
        if handoff_threshold is not None:
            raise NotImplementedError(f"handoff_threshold {_FLEET}")
        if warm_source is not None:
            raise NotImplementedError(f"warm_source {_FLEET}")
        cfg = model.cfg
        self.model = model
        self.device = resolve_device(device)
        self.engine_id = f"e{next(_ENGINE_IDS)}"
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_context = int(min(max_context or cfg.max_len, cfg.max_len))
        if self.slots < 1:
            raise ValueError("need at least one slot")
        if self.max_context < self.page_size:
            raise ValueError(
                f"max_context {self.max_context} < page_size "
                f"{self.page_size}")
        if max_chunk < 1 or (max_chunk & (max_chunk - 1)):
            raise ValueError(
                f"max_chunk must be a power of two >= 1, got {max_chunk}")
        if quantization not in (None, "int8"):
            raise ValueError(f"unknown quantization {quantization!r} "
                             "(expected None or 'int8')")
        self.max_chunk = int(max_chunk)
        self.pages_per_slot = kv_pages.pages_needed(self.max_context,
                                                    self.page_size)
        if n_pages is None:
            n_pages = 1 + self.slots * self.pages_per_slot
        cd = model.compute_dtype
        self.quantization = quantization
        self.params = tree_map(lambda t: t.to(self.device, cd), params)
        # int8 scales come from the caller's (f32) weights, as in JAX
        self._decode_params = (
            self._quantize_decode_params(
                tree_map(lambda t: t.to(self.device), params), self.params)
            if quantization == "int8" else self.params)
        self.kv_dtype = resolve_kv_dtype(kv_dtype)
        self.pool = kv_pages.PagePool(
            cfg.n_layers, cfg.n_heads, self.page_size, cfg.head_dim,
            n_pages, dtype=cd, device=self.device, kv_dtype=self.kv_dtype)
        self.prefill_buckets = self._resolve_buckets(prefill_buckets)
        self.seed = int(seed)
        # sampling generators are seeded from a PER-ENGINE ordinal: two
        # engines built with the same seed sample identically
        self._sample_counter = itertools.count()
        # cross-request KV reuse and speculative decoding
        self._prefix = PrefixCache(self.page_size) if prefix_cache else None
        self._sessions = (SessionStore(session_capacity, session_ttl)
                          if session_capacity > 0 else None)
        self._reuse = self._prefix is not None or self._sessions is not None
        self._spec = SpecConfig.resolve(spec_decode)
        self._spec_draft = (self._spec.make_draft()
                            if self._spec is not None else None)
        # host-side slot state
        S, P = self.slots, self.pages_per_slot
        self._tables = np.zeros((S, P), np.int32)
        self._pos = np.zeros((S,), np.int32)
        self._tok = np.zeros((S,), np.int32)
        self._temps = np.zeros((S,), np.float32)
        self._active = np.zeros((S,), bool)
        self._slot_req: List[Optional[ServingRequest]] = [None] * S
        self._slot_pages: List[List[int]] = [[] for _ in range(S)]
        self._slot_emitted = np.zeros((S,), np.int64)
        self._slot_ids = torch.arange(S, device=self.device)
        # device copies of the slot state that only changes on
        # join/evict (tables/active/temps): re-uploaded when dirty
        self._dev_static = None
        # scheduler. max_queue bounds queued + head-of-line-waiting
        # requests together
        self.max_queue = int(max_queue)
        self._queue: "_queue.Queue" = _queue.Queue(maxsize=max_queue)
        self._waiting: "collections.deque" = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._start_lock = threading.Lock()
        self._dead: Optional[BaseException] = None
        #: requests to cancel at the scheduler's next pass (abort());
        #: client threads add, the scheduler thread drains
        self._aborts: set = set()
        self._abort_lock = threading.Lock()
        # stats
        self.n_requests = 0
        self.n_completed = 0
        self.n_steps = 0          # decode steps (one token per live slot)
        self.n_bursts = 0         # host syncs of the decode loop
        self.n_tokens = 0
        self.decode_seconds = 0.0
        self.prefill_seconds = 0.0
        self.n_warm_admissions = 0    # suffix prefills (prefix/session)
        self.n_spec_proposed = 0
        self.n_spec_accepted = 0
        #: verify passes summed over the ACTIVE lanes they served — the
        #: denominator of tokens per weight read
        self.n_verify_lane_steps = 0
        self.n_verify_dispatches = 0
        self._occupancy_sum = 0.0

    def _resolve_buckets(self, buckets) -> List[int]:
        ps, mc = self.page_size, self.max_context
        if buckets is None:
            buckets, b = [], ps
            while b < mc:
                buckets.append(b)
                b *= 2
            buckets.append(kv_pages.pages_needed(mc, ps) * ps)
        out = sorted({int(b) for b in buckets})
        for b in out:
            if b % ps or b < ps:
                raise ValueError(
                    f"prefill bucket {b} is not a multiple of "
                    f"page_size {ps}")
        return out

    def _bucket(self, n: int) -> int:
        return next((b for b in self.prefill_buckets if b >= n),
                    kv_pages.pages_needed(n, self.page_size) * self.page_size)

    # ------------------------------------------------- int8 decode tree
    @staticmethod
    def _quantize_decode_params(params, cast):
        """int8 weight-only tree for the decode step and the verify
        pass: every matmul weight of ``params`` gets per-output-channel
        scales; ``tok_emb`` is scaled per ROW, so one tensor serves the
        embedding gather (rows) and the tied head (rows become output
        channels of ``x @ W.T``). Biases, norms and positions stay
        float: they come from ``cast``, the compute-dtype tree."""
        def q(w, axis):
            wq = quantize_int8(w, axis=axis)
            return {"q": wq["q"], "s": wq["s"]}

        return {"tok_emb": q(params["tok_emb"], 0),
                "pos_emb": cast["pos_emb"],
                "ln_f": cast["ln_f"],
                "layers": [{
                    "ln1": cl["ln1"], "ln2": cl["ln2"],
                    "wqkv": q(lp["wqkv"], 1), "bqkv": cl["bqkv"],
                    "wo": q(lp["wo"], 1), "bo": cl["bo"],
                    "w1": q(lp["w1"], 1), "b1": cl["b1"],
                    "w2": q(lp["w2"], 1), "b2": cl["b2"],
                } for lp, cl in zip(params["layers"], cast["layers"])]}

    def _rows(self, w, idx):
        """Embedding-row gather, quantization-aware (per-row scales)."""
        cd = self.model.compute_dtype
        idx = idx.long()
        if isinstance(w, dict):
            return w["q"][idx].to(cd) * w["s"][idx][..., None].to(cd)
        return w.to(cd)[idx]

    def _head(self, x, w):
        """Tied LM head ``x @ tok_emb.T`` (per-row scales become
        per-output-column scales of the transpose), in f32."""
        cd = self.model.compute_dtype
        if isinstance(w, dict):
            out = (x @ w["q"].to(cd).T) * w["s"].to(cd)
        else:
            out = x @ w.to(cd).T
        return out.float()

    def _block(self, x, lp, attend):
        """One transformer block in the JAX association: ``x + attn @ wo
        + bo``, then ``x + gelu(ln2(x) @ w1 + b1) @ w2 + b2``, with
        ``attend(q, k, v)`` giving the attention context in ``x``'s
        layout. Matmuls go through ``int8_matmul``."""
        m = self.model
        cd = m.compute_dtype
        d = m.cfg.d_model
        h = m._ln(x, lp["ln1"])
        qkv = int8_matmul(h, lp["wqkv"], cd) + lp["bqkv"].to(cd)
        ctx = attend(*qkv.split(d, dim=-1))
        x = x + int8_matmul(ctx, lp["wo"], cd) + lp["bo"].to(cd)
        h = m._ln(x, lp["ln2"])
        mid = F.gelu(int8_matmul(h, lp["w1"], cd) + lp["b1"].to(cd),
                     approximate="tanh")
        return x + int8_matmul(mid, lp["w2"], cd) + lp["b2"].to(cd)

    # ---------------------------------------------------------- startup
    def start(self) -> "DecodeEngine":
        with self._start_lock:
            if self._thread is not None:
                return self
            if self._dead is not None:
                raise RuntimeError("engine has been shut down")
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ServingEngine")
            self._thread.start()
        return self

    def __enter__(self) -> "DecodeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ----------------------------------------------------------- client
    def _validate(self, prompt_ids, max_new_tokens: int) -> np.ndarray:
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]          # [1, t0] convenience
        if prompt.ndim != 1:
            raise ValueError(
                f"submit() takes ONE sequence per call (got shape "
                f"{prompt.shape}); submit each row — the engine "
                "batches across requests")
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + int(max_new_tokens)
        if total > self.max_context:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_context "
                f"({self.max_context})")
        # every page-table row is a distinct resident page, shared or
        # not; pages a request merely shares are accounted at admission
        if kv_pages.pages_needed(total, self.page_size) > self.pool.capacity:
            raise ValueError(
                f"request needs more KV pages than the pool holds "
                f"({self.pool.capacity}); raise n_pages")
        return prompt

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               sample_seed: Optional[int] = None,
               session_id: Optional[str] = None,
               spec_decode: Optional[bool] = None) -> ServingRequest:
        prompt = self._validate(prompt_ids, max_new_tokens)
        if self._dead is not None or self._stop.is_set():
            raise RuntimeError("engine has been shut down")
        if sample_seed is None:
            sample_seed = int(np.random.SeedSequence(
                [self.seed, next(self._sample_counter)]).generate_state(1)[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(sample_seed))
        req = ServingRequest(next(_REQUEST_IDS), prompt, max_new_tokens,
                             temperature, eos_id, gen,
                             session_id=session_id)
        req.spec_enabled = spec_decode
        req._engine = self
        self._enqueue(req)
        return req

    def submit_prepared(self, *args, **kwargs):
        raise NotImplementedError(f"submit_prepared {_FLEET}")

    def _enqueue(self, req: ServingRequest) -> None:
        if self._thread is None:
            self.start()
        if self._queue.qsize() + len(self._waiting) >= self.max_queue:
            raise CapacityRejected(
                f"admission queue full ({self.max_queue} requests waiting)")
        try:
            self._queue.put_nowait(req)
        except _queue.Full:
            raise CapacityRejected(
                f"admission queue full ({self.max_queue} requests "
                "waiting)") from None
        self.n_requests += 1
        # close the submit/shutdown race: if shutdown's final queue
        # drain happened before our put, _stop was set before it — so
        # seeing _stop clear here proves shutdown will drain AFTER us
        if self._stop.is_set():
            err = self._dead or RuntimeError("engine has been shut down")
            while True:
                try:
                    r = self._queue.get_nowait()
                except _queue.Empty:
                    break
                r._finish("error", err)

    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0, eos_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> np.ndarray:
        """Blocking single-request convenience over submit()."""
        return self.submit(prompt_ids, max_new_tokens, temperature,
                           eos_id).result(timeout)

    def prefix_stats(self) -> Dict[str, Any]:
        """Cross-request KV-reuse stats: the prefix cache's counters,
        shared pages, and the sticky-session table."""
        out: Dict[str, Any] = {
            "enabled": self._prefix is not None,
            "sessions_enabled": self._sessions is not None,
            "page_size": self.page_size,
        }
        if self._prefix is not None:
            out.update(self._prefix.stats())
            out["shared_pages"] = self.pool.shared_pages()
        if self._sessions is not None:
            out["sessions"] = self._sessions.stats()
        return out

    def release_session(self, session_id: str) -> bool:
        """Free a sticky session's pinned pages now (any thread). True
        if the id was pinned."""
        if self._sessions is None:
            return False
        return self._sessions.release(session_id, self.pool)

    def stats(self) -> Dict[str, Any]:
        out = {
            "engine_id": self.engine_id,
            "device": str(self.device),
            "slots": self.slots,
            "page_size": self.page_size,
            "max_context": self.max_context,
            "quantization": self.quantization,
            "kv_dtype": self.pool.dtype_label,
            "prefill_buckets": list(self.prefill_buckets),
            "max_chunk": self.max_chunk,
            "requests": self.n_requests,
            "completed": self.n_completed,
            "decode_steps": self.n_steps,
            "bursts": self.n_bursts,
            "tokens": self.n_tokens,
            "decode_seconds": self.decode_seconds,
            "prefill_seconds": self.prefill_seconds,
            "warm_admissions": self.n_warm_admissions,
            "active_slots": int(self._active.sum()),
            "queued": self.queue_depth(),
            "avg_occupancy": (self._occupancy_sum / self.n_steps
                              if self.n_steps else 0.0),
            "kv_pages": {"capacity": self.pool.capacity,
                         "allocated": self.pool.allocated,
                         "high_water": self.pool.high_water,
                         "shared": self.pool.shared_pages(),
                         "page_bytes": self.pool.bytes_per_page()},
        }
        if self._spec is not None:
            lanes = self.n_verify_lane_steps
            out["spec"] = {
                "k": self._spec.k,
                "verify_dispatches": self.n_verify_dispatches,
                "proposed": self.n_spec_proposed,
                "accepted": self.n_spec_accepted,
                "acceptance": (self.n_spec_accepted / self.n_spec_proposed
                               if self.n_spec_proposed else 0.0),
                # tokens emitted per weight read per decode lane; a
                # plain decode step is 1.0 by construction
                "tokens_per_dispatch": ((self.n_spec_accepted + lanes)
                                        / lanes if lanes else 0.0),
            }
        if self._reuse:
            out["prefix_cache"] = self.prefix_stats()
        return out

    # ------------------------------------------------------------ abort
    def queue_depth(self) -> int:
        """Requests admitted but not yet in a slot."""
        return self._queue.qsize() + len(self._waiting)

    def abort(self, request: ServingRequest) -> bool:
        """Cancel ``request`` from any thread (see
        ``ServingRequest.cancel``). The teardown happens on the
        scheduler thread at its next pass, so no lock is ever taken
        against a decode burst. False when the request already finished
        or the engine is dead (its teardown already failed it)."""
        if request.done:
            return False
        with self._abort_lock:
            self._aborts.add(request)
        if self._dead is not None:
            with self._abort_lock:
                self._aborts.discard(request)
            return False
        return True

    def _process_aborts(self) -> None:
        """Scheduler-thread half of ``abort``: evict cancelled slot
        residents, drop cancelled queued or waiting requests."""
        with self._abort_lock:
            if not self._aborts:
                return
            aborts, self._aborts = self._aborts, set()
        while True:           # queued requests must be visible to drop
            try:
                self._waiting.append(self._queue.get_nowait())
            except _queue.Empty:
                break
        for req in aborts:
            if req.done:
                continue
            for s in range(self.slots):
                if self._slot_req[s] is req:
                    self._evict(s, "cancelled")
                    break
            else:
                if req in self._waiting:
                    self._waiting.remove(req)
                    req._finish("cancelled")

    @property
    def idle(self) -> bool:
        """No request in a slot and none queued."""
        return (not self._active.any() and self._queue.empty()
                and not self._waiting)

    def drain(self, timeout: Optional[float] = None,
              poll_s: float = 0.01) -> bool:
        """Wait for every queued and in-flight request to finish (the
        caller must have stopped submitting). True when drained; False
        on timeout or engine death."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        while not self.idle:
            if self._dead is not None or self._stop.is_set():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll_s)
        return True

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        if self._dead is None:
            self._dead = RuntimeError("engine has been shut down")
        # the scheduler is gone: a cancel that raced shutdown finishes
        # as cancelled, with its partial tokens
        self._process_aborts()
        self._fail_pending(self._dead)
        # drain contract: with every slot failed, releasing the session
        # pins and the cache's own references frees the whole pool
        if self._sessions is not None:
            self._sessions.clear(self.pool)
        if self._prefix is not None:
            self._prefix.clear(self.pool)

    # -------------------------------------------------------- scheduler
    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                while not self._stop.is_set():
                    self._process_aborts()
                    self._admit_waiting()
                    if not self._active.any():
                        try:
                            self._waiting.append(
                                self._queue.get(timeout=0.02))
                        except _queue.Empty:
                            pass
                        continue
                    self._decode_step()
        except Exception as e:           # engine died: strand no one
            log.exception("serving engine %s died", self.engine_id)
            self._dead = e
            self._fail_pending(e)
        finally:
            if self._dead is None:
                self._dead = RuntimeError("engine has been shut down")

    def _fail_pending(self, err: BaseException) -> None:
        for s in range(self.slots):
            if self._slot_req[s] is not None:
                self._evict(s, "error", err)
        pend = list(self._waiting)
        self._waiting.clear()
        while True:
            try:
                pend.append(self._queue.get_nowait())
            except _queue.Empty:
                break
        for req in pend:
            req._finish("error", RuntimeError(
                f"engine stopped before request {req.request_id} "
                f"ran: {err}"))

    def _admit_waiting(self) -> None:
        while True:
            try:
                self._waiting.append(self._queue.get_nowait())
            except _queue.Empty:
                break
        if self._sessions is not None:
            self._sessions.expire(self.pool)     # TTL sweep
        while self._waiting and not self._active.all():
            req = self._waiting[0]
            plan = self._plan_admission(req)
            if plan is None:
                break        # head-of-line waits for evictions
            self._waiting.popleft()
            try:
                self._admit(req, plan)
            except Exception as e:
                self._release_plan(plan)
                req._finish("error", e)

    # ----------------------------------------------- admission planning
    def _shared_pages_hint(self, prompt: np.ndarray,
                           session_id: Optional[str]) -> int:
        """Pages this request would REUSE (pinned session pages, cached
        full-prefix pages) rather than newly allocate: it consumes only
        ``pages_needed(total) - hint`` free pages. Read-only; admission
        re-resolves."""
        if not self._reuse:
            return 0
        if self._sessions is not None and session_id is not None \
                and self._sessions.match_pos(session_id,
                                             prompt) is not None:
            return self._sessions.pages_hint(session_id)
        if self._prefix is not None:
            full = self._prefix.hit_tokens_hint(prompt) // self.page_size
            return min(full, (int(prompt.size) - 1) // self.page_size)
        return 0

    def _alloc_with_evict(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, evicting cold prefix-cache leaves and, as a
        last resort, the oldest pinned session: cached or pinned pages
        never starve a live request. None when the pool is full of live
        readers (the request stays queued)."""
        if n <= 0:
            return []
        while True:
            pages = self.pool.alloc(n)
            if pages is not None:
                return pages
            freed = 0
            if self._prefix is not None:
                freed += self._prefix.evict(
                    self.pool, n - self.pool.free_pages)
            if self.pool.free_pages < n and self._sessions is not None:
                freed += self._sessions.evict_oldest(self.pool)
                # a session's history pages may double as cache entries
                if self._prefix is not None \
                        and self.pool.free_pages < n:
                    freed += self._prefix.evict(
                        self.pool, n - self.pool.free_pages)
            if freed == 0:
                return None

    def _plan_admission(self, req: ServingRequest) \
            -> Optional[Dict[str, Any]]:
        """Where this request's pages come from:

        - ``session``: its ``session_id`` pins a history the prompt
          extends — map the pinned pages, prefill only the new tokens;
        - ``prefix``: the prefix cache holds full (and maybe one
          divergent, copy-on-write) pages of the prompt — share them,
          prefill the suffix;
        - ``cold``: allocate everything, full prefill.

        None when pages cannot be found even after eviction. Every page
        of the plan holds a reference for this request;
        ``_release_plan`` undoes that on admission failure."""
        t0 = int(req.prompt.size)
        total_pages = kv_pages.pages_needed(t0 + req.max_new_tokens,
                                            self.page_size)
        plan: Optional[Dict[str, Any]] = None
        if self._sessions is not None and req.session_id is not None:
            plan = self._plan_session(req, t0, total_pages)
            if plan == "retry":
                return None
        if plan is None and self._prefix is not None:
            hit = self._prefix.lookup_acquire(req.prompt, self.pool)
            new = self._alloc_with_evict(total_pages - len(hit.pages))
            if new is None:
                hit.release(self.pool)
                return None
            self._prefix.record(hit)
            copies, drop = [], []
            if hit.cow_src is not None:
                # mid-page divergence: a private copy of that page; the
                # acquire-reference on the source drops after the copy
                copies = [(hit.cow_src, new[0])]
                drop = [hit.cow_src]
            plan = {"kind": "prefix" if hit.tokens else "cold",
                    "rows": hit.pages + new, "copies": copies,
                    "drop_after_copy": drop, "t_start": hit.tokens}
        if plan is None:
            pages = self._alloc_with_evict(total_pages)
            if pages is None:
                return None
            plan = {"kind": "cold", "rows": pages, "copies": [],
                    "drop_after_copy": [], "t_start": 0}
        return plan

    def _plan_session(self, req: ServingRequest, t0: int,
                      total_pages: int):
        """Sticky-session leg of the planner: None = no resumable
        session (fall through to the prefix cache, releasing a
        contradicted pin), "retry" = resumable but pages are short
        (stay head-of-line), else the session plan."""
        sid = req.session_id
        pos = self._sessions.match_pos(sid, req.prompt)
        if pos is None:
            if self._sessions.pages_hint(sid):
                # the conversation restarted: release the stale pin (its
                # full pages stay reachable through the prefix cache)
                self._sessions.release(sid, self.pool)
            return None
        peeked = self._sessions.peek(sid)
        if peeked is None:         # raced a TTL/capacity eviction
            return None
        peek_pages, peek_pos, _turns = peeked
        ps = self.page_size
        t_start = min(peek_pos, t0 - 1)
        extra_n = total_pages - len(peek_pages)
        idx = t_start // ps
        cow_src = (peek_pages[idx] if idx < len(peek_pages)
                   and self.pool.refcount(peek_pages[idx]) > 1 else None)
        # size the allocation BEFORE take(): a request stalled on pages
        # must not churn take/pin every scheduler pass
        new = self._alloc_with_evict(extra_n
                                     + (1 if cow_src is not None else 0))
        if new is None:
            return "retry"         # session stays pinned untouched
        sess = self._sessions.take(sid)
        if sess is None:           # raced an eviction/release
            if new:
                self.pool.free(new)
            return None
        copies, drop = [], []
        rows = list(sess.pages)
        if cow_src is not None:
            # the resume point sits mid-page in a page other readers
            # still map: write into a private copy instead
            rows[idx] = new[0]
            copies = [(cow_src, new[0])]
            drop = [cow_src]
            new = new[1:]
        rows += new
        if self._prefix is not None:
            self._prefix.record_session(t_start)
        req._session_turns = sess.turns + 1
        return {"kind": "session", "rows": rows, "copies": copies,
                "drop_after_copy": drop, "t_start": t_start}

    def _release_plan(self, plan: Dict[str, Any]) -> None:
        self.pool.free(plan["rows"] + plan["drop_after_copy"])

    # ------------------------------------------------------------ admit
    def _admit(self, req: ServingRequest, plan: Dict[str, Any]) -> None:
        t0 = int(req.prompt.size)
        ps = self.page_size
        rows: List[int] = plan["rows"]
        t_start: int = plan["t_start"]
        kv = self.pool.tree()
        for src, dst in plan["copies"]:
            # copy-on-write BEFORE any write can land in the shared
            # page: its other readers never see our tokens
            kv_pages.copy_page(kv, src, dst)
        if plan["drop_after_copy"]:
            self.pool.free(plan["drop_after_copy"])
            plan["drop_after_copy"] = []
        t_pre = time.perf_counter()
        if t_start == 0:
            bucket = self._bucket(t0)
            prompt = np.zeros((1, bucket), np.int64)
            prompt[0, :t0] = req.prompt
            page_row = np.zeros((bucket // ps,), np.int64)
            n_real = min(len(rows), bucket // ps)
            page_row[:n_real] = rows[:n_real]
            ks, vs, last = prefill_forward(
                self.model, self.params,
                torch.tensor(prompt, device=self.device), t0)
            # t0 bounds the real positions: fp8 page scales are minted
            # from them only, never from the padding
            kv_pages.commit_prefill(kv, ks, vs, page_row, ps, n_valid=t0)
            last = last.float()
        else:
            # warm path: prefill ONLY the uncached suffix, mid-page
            # starts included; attention reads the shared prefix pages
            # through the whole table
            sl = t0 - t_start
            suffix = np.zeros((self._bucket(sl),), np.int64)
            suffix[:sl] = req.prompt[t_start:]
            table = np.zeros((self.pages_per_slot,), np.int32)
            table[:len(rows)] = rows
            last = self._prefix_prefill(suffix, table, t_start, t0)
            self.n_warm_admissions += 1
        first = self._sample_first(req, last)
        self.prefill_seconds += time.perf_counter() - t_pre
        s = int(np.flatnonzero(~self._active)[0])
        req.cache_hit_tokens = t_start
        self._slot_req[s] = req
        self._slot_pages[s] = rows
        self._slot_emitted[s] = 0
        self._tables[s] = 0
        self._tables[s, :len(rows)] = rows
        self._pos[s] = t0
        self._tok[s] = first
        self._temps[s] = req.temperature
        self._active[s] = True
        self._dev_static = None      # roster changed: re-upload
        if self._prefix is not None:
            # index this prompt's full pages (fresh ones and, on a
            # session resume, the committed history pages)
            self._prefix.insert(req.prompt, rows, self.pool)
        self._emit(s, first)

    def _prefix_prefill(self, tokens: np.ndarray, table: np.ndarray,
                        t_start: int, t0: int):
        """SUFFIX prefill of a warm admission: one forward over the
        padded new tokens (bucket width ``B``) at absolute positions
        ``t_start ..``, attending through the slot's WHOLE page table
        (the shared prefix pages are read in place; only the suffix
        positions' K/V is computed and written, padded lanes to the null
        page). ``t_start`` may sit mid-page. Float weights, as the JAX
        program. Returns the last real position's logits in f32."""
        m = self.model
        cfg = m.cfg
        p = self.params
        dev = self.device
        P, ps = self.pages_per_slot, self.page_size
        B = tokens.shape[0]
        H, hd = cfg.n_heads, cfg.head_dim
        pos = t_start + torch.arange(B, device=dev)
        table_t = torch.tensor(table, dtype=torch.int32, device=dev)
        x = self._rows(p["tok_emb"], torch.tensor(tokens, device=dev)) \
            + p["pos_emb"][pos.clamp(max=cfg.max_len - 1)]
        real = pos < t0
        chunk = torch.clamp(pos // ps, max=P - 1)
        page = torch.where(real, table_t.long()[chunk],
                           torch.zeros_like(chunk))
        off = pos % ps
        # fp8 scale segments: padded lanes land in the trash segment P
        seg = torch.where(real, chunk, torch.full_like(chunk, P))
        qbase = torch.tensor([t_start], dtype=torch.int32, device=dev)
        kv = self.pool.tree()
        for li, lp in enumerate(p["layers"]):
            def attend(q, k, v, li=li):
                k, v = k.reshape(B, H, hd), v.reshape(B, H, hd)
                kv_pages.append_suffix(kv, li, page, off, k, v, chunk=seg,
                                       real=real, table=table_t)
                qq = q.reshape(B, H, hd).transpose(0, 1)[None].contiguous()
                ctx = paged_attention(qq, kv, li, table_t[None], qbase)
                return ctx[0].transpose(0, 1).reshape(B, cfg.d_model)
            x = self._block(x, lp, attend)
        x = m._ln(x[t0 - 1 - t_start], p["ln_f"])
        return self._head(x, p["tok_emb"])

    def _sample_first(self, req: ServingRequest, logits) -> int:
        """The first token, picked on the host from the prefill's last
        real position (greedy) or sampled with the request's
        generator."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits.cpu().numpy()))
        noise = gumbel_noise(logits.shape, req.generator, logits.device)
        return int((logits / req.temperature + noise).argmax())

    def _dev_slot_state(self):
        """tables/active/temps change only on join/evict: upload once
        per roster change, not once per step."""
        if self._dev_static is None:
            dev = self.device
            self._dev_static = (torch.tensor(self._tables, device=dev),
                                torch.tensor(self._active, device=dev),
                                torch.tensor(self._temps, device=dev))
        return self._dev_static

    # ----------------------------------------------------------- decode
    def _step(self, tables, pos, tok, temps, sampled: List[int]):
        """One fixed-shape decode step for all slots. Mirrors
        ``CausalLM._decode_one`` op for op (same residual association,
        same mask value), with K/V in the paged pools: each layer
        appends this position's K/V, then attends through the page
        tables. Returns the next token of every slot ``[S]`` int32."""
        cfg = self.model.cfg
        p = self._decode_params
        S, ps = self.slots, self.page_size
        kv = self.pool.tree()
        x = self._rows(p["tok_emb"], tok) + p["pos_emb"][pos.long()]
        # inactive slots carry all-null tables, so their writes land on
        # the null page by construction
        page = tables[self._slot_ids, (pos // ps).long()].long()
        off = (pos % ps).long()
        for li, lp in enumerate(p["layers"]):
            def attend(q, k, v, li=li):
                hs = (S, cfg.n_heads, 1, cfg.head_dim)
                q, k, v = q.reshape(hs), k.reshape(hs), v.reshape(hs)
                kv_pages.append_token(kv, li, page, off, k[:, :, 0],
                                      v[:, :, 0])
                ctx = paged_attention(q.contiguous(), kv, li, tables, pos)
                return ctx.reshape(S, cfg.d_model)
            x = self._block(x, lp, attend)
        x = self.model._ln(x, p["ln_f"])
        logits = self._head(x, p["tok_emb"])
        nxt = logits.argmax(dim=-1).to(torch.int32)
        if sampled:
            idx = torch.tensor(sampled, device=self.device)
            noise = torch.stack([
                gumbel_noise(logits.shape[1:], self._slot_req[s].generator,
                             self.device) for s in sampled])
            pick = (logits[idx] / temps[idx, None] + noise).argmax(dim=-1)
            nxt[idx] = pick.to(torch.int32)
        return nxt

    def _decode_step(self) -> None:
        """One decode BURST: chunks of steps back to back, pos/tok kept
        on the device, and ONE host copy at the end, taken only when
        the roster can change: the nearest request completion, an
        active eos_id (completion unpredictable -> a single chunk), or
        a queued request that could join a free slot. With speculative
        decoding on, a verify burst runs instead whenever some slot has
        drafts."""
        if self._spec is not None and self._spec_burst():
            return
        t0 = time.perf_counter()
        active_idx = np.flatnonzero(self._active)
        min_rem = min(
            self._slot_req[s].max_new_tokens - int(self._slot_emitted[s])
            for s in active_idx)
        has_eos = any(self._slot_req[s].eos_id is not None
                      for s in active_idx)
        free_slots = not self._active.all()
        sampled = [int(s) for s in active_idx if self._temps[s] > 0]
        tables, active, temps = self._dev_slot_state()
        pos = torch.tensor(self._pos, device=self.device)
        tok = torch.tensor(self._tok, device=self.device)
        step_inc = active.to(pos.dtype)
        occupancy = float(len(active_idx)) / self.slots
        toks: List[torch.Tensor] = []
        chunks = 0
        while True:
            steps = len(toks)
            k = 1
            while k * 2 <= min(min_rem - steps, self.max_chunk):
                k *= 2
            for _ in range(k):
                nxt = self._step(tables, pos, tok, temps, sampled)
                pos = pos + step_inc
                tok = torch.where(active, nxt, tok)
                toks.append(nxt)
            chunks += 1
            if has_eos or len(toks) >= min_rem \
                    or chunks >= self.MAX_BURST_CHUNKS:
                break
            if free_slots and not self._queue.empty():
                break          # a waiting request can join a free slot
        steps = len(toks)
        # ONE host copy for the whole burst: tokens, then pos and tok
        host = torch.cat([torch.stack(toks, dim=1), pos[:, None],
                          tok[:, None]], dim=1).cpu().numpy()
        self._pos = host[:, steps].copy()
        self._tok = host[:, steps + 1].copy()
        self.n_steps += steps
        self.n_bursts += 1
        self._occupancy_sum += occupancy * steps
        self.decode_seconds += time.perf_counter() - t0
        for s in active_idx:
            for i in range(steps):
                if not self._active[s]:
                    break              # finished on eos mid-chunk
                self._emit(int(s), int(host[s, i]))

    # ------------------------------------------------------ speculative
    def _verify(self, tables, pos, active, tok, drafts, n_draft):
        """Speculative VERIFY pass: scores the pending token plus ``K``
        drafts per slot — ``W = K + 1`` consecutive positions
        ``pos[s] .. pos[s] + K`` — through the DECODE weights, then
        accepts the longest draft prefix the target agrees with. The
        suffix-prefill machinery batched over slots: per-lane (page,
        offset) writes (``kv_pages.append_spec``) BEFORE attending, so
        draft ``i`` is scored with the K/V of drafts ``1 .. i - 1``, and
        attention through each slot's whole table at query positions
        ``pos[s] + i``. Rollback is positional only
        (``kv_pages.spec_rewind``). Returns (out ``[S, W]``, advance
        ``[S]``, new pos, new tok) on the device."""
        m = self.model
        cfg = m.cfg
        p = self._decode_params
        dev = self.device
        S, ps, P = self.slots, self.page_size, self.pages_per_slot
        W = drafts.shape[1] + 1
        H, hd = cfg.n_heads, cfg.head_dim
        toks = torch.cat([tok[:, None], drafts.to(tok.dtype)], dim=1)
        posw = pos.long()[:, None] + torch.arange(W, device=dev)[None, :]
        x = self._rows(p["tok_emb"], toks) \
            + p["pos_emb"][posw.clamp(max=cfg.max_len - 1)]
        # lane 0 is the pending token (real while the slot is live);
        # lane i >= 1 is draft i, real up to n_draft
        real = (torch.arange(W, device=dev)[None, :]
                <= n_draft.long()[:, None]) & active[:, None]
        chunk = torch.clamp(posw // ps, max=P - 1)
        page = torch.where(real, tables.long().gather(1, chunk),
                           torch.zeros_like(chunk))
        off = posw % ps
        seg = torch.where(real, chunk, torch.full_like(chunk, P))
        kv = self.pool.tree()
        for li, lp in enumerate(p["layers"]):
            def attend(q, k, v, li=li):
                k, v = k.reshape(S, W, H, hd), v.reshape(S, W, H, hd)
                kv_pages.append_spec(kv, li, page, off, k, v, chunk=seg,
                                     real=real, tables=tables)
                qq = q.reshape(S, W, H, hd).transpose(1, 2).contiguous()
                ctx = paged_attention(qq, kv, li, tables, pos)
                return ctx.transpose(1, 2).reshape(S, W, cfg.d_model)
            x = self._block(x, lp, attend)
        x = m._ln(x, p["ln_f"])
        logits = self._head(x, p["tok_emb"])                  # [S, W, V]
        gens = [r.generator if r is not None else None
                for r in self._slot_req]
        out, n_acc = accept_tokens(logits, drafts, n_draft, self._temps,
                                   gens)
        adv = torch.where(active, n_acc, torch.zeros_like(n_acc))
        new_pos = kv_pages.spec_rewind(pos, adv)
        corr = out.gather(1, (n_acc.long() - 1)[:, None])[:, 0]
        new_tok = torch.where(active, corr, tok)
        return out, adv, new_pos, new_tok

    def _spec_burst(self) -> bool:
        """One draft -> verify burst: the host drafts up to ``k`` tokens
        per eligible slot from its own emitted history, ONE verify pass
        scores every slot, and the accepted prefix plus the correction
        is emitted (one host copy). Slots that opted out or have one
        token of budget left ride along with no drafts, op for op a
        plain decode step. False when no active slot has a draft: the
        caller runs the plain chunked burst."""
        t0 = time.perf_counter()
        active_idx = np.flatnonzero(self._active)
        K, S = self._spec.k, self.slots
        drafts = np.zeros((S, K), np.int32)
        n_draft = np.zeros((S,), np.int32)
        for s in active_idx:
            req = self._slot_req[int(s)]
            if req.spec_enabled is False:
                continue
            # never draft past the budget: the correction always emits
            rem = req.max_new_tokens - int(self._slot_emitted[s])
            nd = min(K, rem - 1)
            if nd <= 0:
                continue
            history = np.concatenate(
                [req.prompt, np.asarray(req.tokens, np.int32)])
            prop = np.asarray(self._spec_draft.propose(history, nd),
                              np.int32).ravel()[:nd]
            drafts[s, :prop.size] = prop
            n_draft[s] = prop.size
        if not n_draft.any():
            return False
        tables, active, _ = self._dev_slot_state()
        dev = self.device
        out, adv, pos, tok = self._verify(
            tables, torch.tensor(self._pos, device=dev), active,
            torch.tensor(self._tok, device=dev),
            torch.tensor(drafts, device=dev),
            torch.tensor(n_draft, device=dev))
        # ONE host copy: tokens, advance, pos, tok
        host = torch.cat([out, adv[:, None], pos[:, None].to(out.dtype),
                          tok[:, None].to(out.dtype)], dim=1).cpu().numpy()
        W = K + 1
        out, nacc = host[:, :W], host[:, W]
        self._pos = host[:, W + 1].copy()
        self._tok = host[:, W + 2].copy()
        occupancy = float(len(active_idx)) / S
        self.n_steps += 1
        self.n_bursts += 1
        self.n_verify_dispatches += 1
        self._occupancy_sum += occupancy
        self.n_verify_lane_steps += int(len(active_idx))
        self.n_spec_proposed += int(n_draft[active_idx].sum())
        self.n_spec_accepted += int((nacc[active_idx] - 1).sum())
        self.decode_seconds += time.perf_counter() - t0
        for s in active_idx:
            req = self._slot_req[int(s)]
            req.spec_proposed += int(n_draft[s])
            req.spec_accepted += int(nacc[s] - 1)
            for i in range(int(nacc[s])):
                if not self._active[s]:
                    break          # finished on eos mid-acceptance
                self._emit(int(s), int(out[s, i]))
        return True

    # ------------------------------------------------------------ emit
    def _emit(self, s: int, token: int) -> None:
        req = self._slot_req[s]
        req._push(token)
        self._slot_emitted[s] += 1
        self.n_tokens += 1
        if self._slot_emitted[s] >= req.max_new_tokens:
            self._evict(s, "length")
        elif req.eos_id is not None and token == req.eos_id:
            self._evict(s, "eos")

    def _evict(self, s: int, reason: str,
               error: Optional[BaseException] = None) -> None:
        req = self._slot_req[s]
        if not self._maybe_pin_session(s, req, reason, error):
            self.pool.free(self._slot_pages[s])
        self._slot_req[s] = None
        self._slot_pages[s] = []
        self._slot_emitted[s] = 0
        self._tables[s] = 0      # all-null row: decode writes -> page 0
        self._pos[s] = 0
        self._tok[s] = 0
        self._temps[s] = 0.0
        self._active[s] = False
        self._dev_static = None      # roster changed: re-upload
        self.n_completed += 1
        req._finish(reason, error)

    def _maybe_pin_session(self, s: int, req: ServingRequest, reason: str,
                           error: Optional[BaseException]) -> bool:
        """On a clean finish of a ``session_id`` request, pin the
        COMMITTED state under that id instead of freeing it: the token
        history whose K/V landed in the pool (prompt + every generated
        token but the last, which was emitted, never fed back) and the
        pages holding it. Pages past the committed extent are freed."""
        if (error is not None or reason not in ("length", "eos")
                or req.session_id is None or self._sessions is None):
            return False
        pages = self._slot_pages[s]
        history = np.concatenate(
            [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        keep = kv_pages.pages_needed(history.size, self.page_size)
        if not 0 < keep <= len(pages):
            return False
        if len(pages) > keep:
            self.pool.free(pages[keep:])
        self._sessions.pin(req.session_id, pages[:keep], history,
                           self.pool, turns=req._session_turns)
        return True


__all__ = ["DecodeEngine", "ServingRequest", "CapacityRejected",
           "prefill_forward"]
