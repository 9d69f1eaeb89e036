"""Speculative decoding for the serving engine: draft -> verify.

Counterpart of ``deeplearning4j_tpu/serving/spec_decode.py``. A cheap
draft proposes up to ``k`` tokens per slot (the host-side n-gram
self-draft by default, or any object with a ``propose`` method); ONE
verify pass of the engine scores all ``k + 1`` positions through the
target model, and :func:`accept_tokens` keeps the longest draft prefix
the target agrees with plus one correction or bonus token, so every
verify emits between 1 and ``k + 1`` tokens for one read of the
weights.

Acceptance (rejection sampling specialised to a deterministic draft):

- greedy (temperature 0): draft ``d_i`` is accepted iff it equals the
  target argmax at its position, so the emitted tokens are exactly the
  plain greedy rollout — equal to the JAX engine's, token for token;
- temperature > 0: ``d_i`` is accepted with probability ``p(d_i)``; at
  the first rejection the correction is drawn from ``p`` with ``d_i``
  removed and renormalised, and when every draft survives a bonus token
  is drawn from the next row. The emitted marginal is the target
  distribution (Leviathan et al., arXiv:2211.17192). The draws come
  from the request's own ``torch.Generator``, so they follow the JAX
  engine's law but are not its draws.

Rejected drafts need no cleanup on the device: their K/V sits past the
rolled-back position, invisible to attention, until the next verify
overwrites it (``kv_pages.append_spec``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.gpt import gumbel_noise


class NGramDraft:
    """Prompt-lookup / n-gram self-draft (host-side, no device work):
    propose the ``k`` tokens that FOLLOWED the most recent earlier
    occurrence of the history's trailing n-gram, longest match first.
    Fully deterministic."""

    def __init__(self, match_len: int = 3):
        if match_len < 1:
            raise ValueError("match_len must be >= 1")
        self.match_len = int(match_len)

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """``k`` candidate continuations of ``history`` (1-D int array
        of prompt + all emitted tokens). Always returns exactly ``k``
        tokens; the fallback repeats the last token."""
        h = np.asarray(history, np.int32).ravel()
        L = h.size
        out: Optional[np.ndarray] = None
        for n in range(min(self.match_len, L - 1), 0, -1):
            pat = h[L - n:]
            # candidate starts strictly before the trailing occurrence
            win = np.lib.stride_tricks.sliding_window_view(h, n)[:L - n]
            hits = np.flatnonzero((win == pat).all(axis=1))
            if hits.size:
                j = int(hits[-1]) + n
                out = h[j:j + k]
                break
        if out is None or out.size == 0:
            last = h[-1] if L else np.int32(0)
            return np.full((k,), last, np.int32)
        if out.size < k:
            out = np.concatenate(
                [out, np.full((k - out.size,), out[-1], np.int32)])
        return out.astype(np.int32)


@dataclass
class SpecConfig:
    """Engine-level speculative-decoding configuration.

    k : drafts proposed (and verified) per slot per verify pass; the
        verify pass is ``k + 1`` positions wide.
    draft : ``"ngram"`` (the built-in self-draft) or any object with
        ``propose(history, k) -> np.ndarray``.
    match_len : longest trailing n-gram the n-gram draft matches on
        (ignored for custom draft objects).
    """

    k: int = 4
    draft: Any = "ngram"
    match_len: int = 3

    def __post_init__(self):
        self.k = int(self.k)
        if self.k < 1:
            raise ValueError(f"spec_decode k must be >= 1, got {self.k}")

    @classmethod
    def resolve(cls, spec) -> Optional["SpecConfig"]:
        """Canonicalise the engine's ``spec_decode=`` argument:
        None/False -> off, int -> k drafts of n-gram self-draft,
        "ngram"/True -> defaults, dict -> kwargs, SpecConfig -> itself."""
        if spec is None or spec is False:
            return None
        if isinstance(spec, cls):
            return spec
        if spec is True:
            return cls()
        if isinstance(spec, int):
            return cls(k=spec)
        if isinstance(spec, str):
            if spec != "ngram":
                raise ValueError(
                    f"unknown spec_decode draft {spec!r} (expected "
                    "'ngram', an int k, a dict, or a SpecConfig)")
            return cls()
        if isinstance(spec, dict):
            return cls(**spec)
        raise ValueError(f"cannot resolve spec_decode={spec!r}")

    def make_draft(self):
        if self.draft == "ngram":
            return NGramDraft(self.match_len)
        if not hasattr(self.draft, "propose"):
            raise ValueError(
                "spec_decode draft must be 'ngram' or expose "
                "propose(history, k)")
        return self.draft


Generators = Union[None, torch.Generator,
                   Sequence[Optional[torch.Generator]]]


def accept_tokens(logits, drafts, n_draft, temps, generators: Generators = None):
    """Rejection-sampling acceptance over one verify pass's logits.

    logits : ``[S, W, V]`` — row ``i`` of slot ``s`` is the target's
        distribution for the token FOLLOWING position ``pos[s] + i``.
    drafts : ``[S, K]`` int (``W = K + 1``); draft column ``i`` is scored
        against logits row ``i``.
    n_draft : ``[S]`` int, 0..K — real drafts per slot; later columns
        are padding and never accepted.
    temps : ``[S]`` host temperatures (numpy or list); <= 0 is greedy.
    generators : where sampled rows draw from — one ``torch.Generator``
        for every row, or one per row (None for greedy rows). Each
        sampled row draws ``K`` uniforms, ``K x V`` residual Gumbel
        noise and ``V`` bonus noise, in that order, whatever is
        accepted, so replays are deterministic per seed.

    Returns ``(out [S, W] int32, n_acc [S] int32)`` on the logits'
    device: ``out[s, :n_acc[s]]`` are the emitted tokens (the accepted
    draft prefix, then one correction or bonus token; columns past it
    repeat the correction), ``1 <= n_acc <= n_draft + 1``."""
    S, W, V = logits.shape
    K = W - 1
    dev = logits.device
    logits = logits.to(torch.float32)
    drafts = torch.as_tensor(drafts, device=dev).long()
    n_draft = torch.as_tensor(n_draft, device=dev).long()
    temps = np.asarray(temps, np.float32).reshape(S)
    greedy = logits.argmax(dim=-1)                               # [S, W]
    ok = drafts == greedy[:, :K]
    corr_sampled = torch.zeros((S,), dtype=torch.long, device=dev)
    sampled = [s for s in range(S) if temps[s] > 0]
    if sampled:
        idx = torch.tensor(sampled, device=dev)
        t = torch.tensor(temps[sampled], device=dev)[:, None, None]
        scaled = logits[idx] / t                                 # [s, W, V]
        p = torch.softmax(scaled[:, :K], dim=-1)
        p_draft = p.gather(-1, drafts[idx][..., None])[..., 0]   # [s, K]
        u, g_rej, g_bonus = [], [], []
        for s in sampled:
            g = (generators if isinstance(generators, torch.Generator)
                 or generators is None else generators[s])
            if g is None:
                raise ValueError(f"row {s} samples (temperature "
                                 f"{temps[s]}) but has no generator")
            u.append(torch.rand((K,), generator=g, device=dev))
            g_rej.append(gumbel_noise((K, V), g, dev))
            g_bonus.append(gumbel_noise((V,), g, dev))
        # residual at rejection i: p with d_i removed and renormalised
        hole = torch.zeros_like(scaled[:, :K], dtype=torch.bool).scatter_(
            -1, drafts[idx][..., None], True)
        residual = scaled[:, :K].masked_fill(hole, float("-inf"))
        rej = (residual + torch.stack(g_rej)).argmax(dim=-1)     # [s, K]
        bonus_row = scaled.gather(
            1, n_draft[idx][:, None, None].expand(-1, 1, V))[:, 0]
        bonus = (bonus_row + torch.stack(g_bonus)).argmax(dim=-1)
        ok_s = torch.stack(u) < p_draft
        ok[idx] = ok_s
        m_s = torch.cumprod((ok_s & (torch.arange(K, device=dev)[None, :]
                                     < n_draft[idx][:, None])).long(),
                            dim=1).sum(dim=1)
        rej_m = rej.gather(1, m_s.clamp(max=max(K - 1, 0))[:, None])[:, 0]
        corr_sampled[idx] = torch.where(m_s < n_draft[idx], rej_m, bonus)
    ok = ok & (torch.arange(K, device=dev)[None, :] < n_draft[:, None])
    # m = length of the leading accepted prefix (0..n_draft)
    m = torch.cumprod(ok.long(), dim=1).sum(dim=1)               # [S]
    greedy_m = greedy.gather(1, m[:, None])[:, 0]
    is_sampled = torch.as_tensor(temps > 0, device=dev)
    corr = torch.where(is_sampled, corr_sampled, greedy_m)
    cols = torch.arange(W, device=dev)[None, :]
    drafts_w = torch.cat([drafts, drafts[:, :1]], dim=1)
    out = torch.where(cols < m[:, None], drafts_w, corr[:, None])
    return out.to(torch.int32), (m + 1).to(torch.int32)


__all__ = ["SpecConfig", "NGramDraft", "accept_tokens"]
