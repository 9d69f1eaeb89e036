"""Continuous-batching decode engine over the port's ``CausalLM``.

Counterpart of ``deeplearning4j_tpu/serving/engine.py``, cold path only:

- **Slot-based fixed-shape decode step.** A static batch of ``slots``
  decode lanes; each slot carries its own KV pages, position and
  sampling state. A finished request's slot is refilled from the queue
  between bursts while its neighbours keep decoding.
- **Paged KV cache** (kv_pages.py): one page pool allocated at startup,
  per-slot page tables. Each request gets ``pages_needed(prompt +
  max_new)`` pages at admission, head-of-line FIFO.
- **Bucketed prefill**: a prompt is padded to the smallest prefill
  bucket that holds it and run through one batched forward
  (:func:`prefill_forward`); its K/V is committed into its pages and the
  first token is picked on the host from the last real position.
- **Chunked bursts**: decode steps run back to back with no host sync
  until the roster can change — the nearest request completion, one
  chunk when any active request has an ``eos_id``, or a queued request
  that could join a free slot — and the burst's tokens come to the host
  in one copy.

The decode step's attention goes through ``ops/paged_attention.py``: the
hand-written CUDA kernel on the card, the plain PyTorch reference on the
CPU. The step appends the new position's K/V to the pools before it
attends, as the JAX engine does.

Greedy parity contract (tested at f32): every request decoded through
the engine produces the same tokens as a solo ``CausalLM.generate()``
call and as the JAX engine. Sampling draws Gumbel noise from one
``torch.Generator`` per request, seeded from ``sample_seed`` or from the
engine seed and the request's ordinal, so a request's samples do not
depend on what else is in flight; they are not the JAX engine's draws.

Not ported here (later slices): prefix cache, sticky sessions,
speculative decoding, int8 weights, fp8 KV, fleet handoff, request
cancellation, telemetry, tracing and the flight recorder. The JAX
engine's ahead-of-time warm pool has no counterpart: PyTorch runs
eagerly.
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

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.gpt import gumbel_noise
from deeplearning4j_tpu_torch.params import tree_map
from deeplearning4j_tpu_torch.ops.paged_attention import paged_attention
from deeplearning4j_tpu_torch.serving import kv_pages

log = logging.getLogger("deeplearning4j_tpu_torch")

#: process-wide request ids
_REQUEST_IDS = itertools.count()
#: process-wide engine ordinals (engine ids in logs and stats)
_ENGINE_IDS = itertools.count()


class CapacityRejected(RuntimeError):
    """The admission queue is full."""


class ServingRequest:
    """Handle for one submitted generation request.

    ``result()`` blocks until completion and returns the generated
    tokens (np.int32, length <= max_new_tokens — shorter on EOS).
    ``stream()`` yields tokens as the engine emits them. ``ttft_s`` /
    ``latency_s`` are filled in as the request progresses."""

    def __init__(self, request_id: int, prompt: np.ndarray,
                 max_new_tokens: int, temperature: float,
                 eos_id: Optional[int], generator: torch.Generator):
        self.request_id = request_id
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.generator = generator
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None   # length | eos | error
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
    max_chunk : upper bound (a power of two) on decode steps per chunk;
        a burst chains up to ``MAX_BURST_CHUNKS`` chunks.
    device : where the engine runs; default the CUDA card. With no card
        and no ``device``, construction raises.
    """

    #: chunks chained per burst before tokens are fetched and emitted
    #: (bounds streaming latency)
    MAX_BURST_CHUNKS = 4

    def __init__(self, model, params, *, slots: int = 8,
                 page_size: int = 16, max_context: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 max_chunk: int = 8, max_queue: int = 512, seed: int = 0,
                 device=None):
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
        self.max_chunk = int(max_chunk)
        self.pages_per_slot = kv_pages.pages_needed(self.max_context,
                                                    self.page_size)
        if n_pages is None:
            n_pages = 1 + self.slots * self.pages_per_slot
        cd = model.compute_dtype
        self.params = tree_map(lambda t: t.to(self.device, cd), params)
        self.pool = kv_pages.PagePool(
            cfg.n_layers, cfg.n_heads, self.page_size, cfg.head_dim,
            n_pages, dtype=cd, device=self.device)
        self.prefill_buckets = self._resolve_buckets(prefill_buckets)
        self.seed = int(seed)
        # sampling generators are seeded from a PER-ENGINE ordinal: two
        # engines built with the same seed sample identically
        self._sample_counter = itertools.count()
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
        # stats
        self.n_requests = 0
        self.n_completed = 0
        self.n_steps = 0          # decode steps (one token per live slot)
        self.n_bursts = 0         # host syncs of the decode loop
        self.n_tokens = 0
        self.decode_seconds = 0.0
        self.prefill_seconds = 0.0
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
        if kv_pages.pages_needed(total, self.page_size) > self.pool.capacity:
            raise ValueError(
                f"request needs more KV pages than the pool holds "
                f"({self.pool.capacity}); raise n_pages")
        return prompt

    def submit(self, prompt_ids, max_new_tokens: int,
               temperature: float = 0.0, eos_id: Optional[int] = None,
               sample_seed: Optional[int] = None) -> ServingRequest:
        prompt = self._validate(prompt_ids, max_new_tokens)
        if self._dead is not None or self._stop.is_set():
            raise RuntimeError("engine has been shut down")
        if sample_seed is None:
            sample_seed = int(np.random.SeedSequence(
                [self.seed, next(self._sample_counter)]).generate_state(1)[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(sample_seed))
        req = ServingRequest(next(_REQUEST_IDS), prompt, max_new_tokens,
                             temperature, eos_id, gen)
        self._enqueue(req)
        return req

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

    def stats(self) -> Dict[str, Any]:
        return {
            "engine_id": self.engine_id,
            "device": str(self.device),
            "slots": self.slots,
            "page_size": self.page_size,
            "max_context": self.max_context,
            "prefill_buckets": list(self.prefill_buckets),
            "max_chunk": self.max_chunk,
            "requests": self.n_requests,
            "completed": self.n_completed,
            "decode_steps": self.n_steps,
            "bursts": self.n_bursts,
            "tokens": self.n_tokens,
            "decode_seconds": self.decode_seconds,
            "prefill_seconds": self.prefill_seconds,
            "active_slots": int(self._active.sum()),
            "queued": self._queue.qsize() + len(self._waiting),
            "avg_occupancy": (self._occupancy_sum / self.n_steps
                              if self.n_steps else 0.0),
            "kv_pages": {"capacity": self.pool.capacity,
                         "allocated": self.pool.allocated,
                         "high_water": self.pool.high_water,
                         "page_bytes": self.pool.bytes_per_page()},
        }

    def shutdown(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        if self._dead is None:
            self._dead = RuntimeError("engine has been shut down")
        self._fail_pending(self._dead)

    # -------------------------------------------------------- scheduler
    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                while not self._stop.is_set():
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
        while self._waiting and not self._active.all():
            req = self._waiting[0]
            total = int(req.prompt.size) + req.max_new_tokens
            pages = self.pool.alloc(
                kv_pages.pages_needed(total, self.page_size))
            if pages is None:
                break        # head-of-line waits for evictions
            self._waiting.popleft()
            try:
                self._admit(req, pages)
            except Exception as e:
                self.pool.free(pages)
                req._finish("error", e)

    def _admit(self, req: ServingRequest, rows: List[int]) -> None:
        t0 = int(req.prompt.size)
        ps = self.page_size
        bucket = next((b for b in self.prefill_buckets if b >= t0),
                      kv_pages.pages_needed(t0, ps) * ps)
        prompt = np.zeros((1, bucket), np.int64)
        prompt[0, :t0] = req.prompt
        page_row = np.zeros((bucket // ps,), np.int64)
        n_real = min(len(rows), bucket // ps)
        page_row[:n_real] = rows[:n_real]
        t_pre = time.perf_counter()
        ks, vs, last = prefill_forward(
            self.model, self.params,
            torch.tensor(prompt, device=self.device), t0)
        kv_pages.commit_prefill(self.pool.tree(), ks, vs, page_row, ps)
        first = self._sample_first(req, last.float())
        self.prefill_seconds += time.perf_counter() - t_pre
        s = int(np.flatnonzero(~self._active)[0])
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
        self._emit(s, first)

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

    def _step(self, tables, pos, tok, temps, sampled: List[int]):
        """One fixed-shape decode step for all slots. Mirrors
        ``CausalLM._decode_one`` op for op (same residual association,
        same mask value), with K/V in the paged pools: each layer
        appends this position's K/V, then attends through the page
        tables. Returns the next token of every slot ``[S]`` int32."""
        m = self.model
        cfg = m.cfg
        p = self.params
        S, ps = self.slots, self.page_size
        kv = self.pool.tree()
        x = p["tok_emb"][tok.long()] + p["pos_emb"][pos.long()]
        # inactive slots carry all-null tables, so their writes land on
        # the null page by construction
        page = tables[self._slot_ids, (pos // ps).long()].long()
        off = (pos % ps).long()
        for li, lp in enumerate(p["layers"]):
            h = m._ln(x, lp["ln1"])
            qkv = h @ lp["wqkv"] + lp["bqkv"]
            q, k, v = (y.reshape(S, cfg.n_heads, 1, cfg.head_dim)
                       for y in qkv.split(cfg.d_model, dim=-1))
            kv_pages.append_token(kv, li, page, off, k[:, :, 0], v[:, :, 0])
            ctx = paged_attention(q.contiguous(), kv, li, tables, pos)
            x = x + ctx.reshape(S, cfg.d_model) @ lp["wo"] + lp["bo"]
            x = x + m.mlp(x, lp) + lp["b2"]
        x = m._ln(x, p["ln_f"])
        logits = (x @ p["tok_emb"].T).float()
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
        a queued request that could join a free slot."""
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


__all__ = ["DecodeEngine", "ServingRequest", "CapacityRejected",
           "prefill_forward"]
