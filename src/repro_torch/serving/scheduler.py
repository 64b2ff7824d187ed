"""Continuous-batching serve scheduler (host-side control plane), the
port of ``repro/serving/scheduler.py``.

Slots hold in-flight requests; finished/empty slots are refilled from the
queue each step so the decode batch stays full — the serving analogue of
the paper's TSU keeping PUs busy from the input queues (§II-B): slot
occupancy is the IQ, the admission queue is the OQ, and refill priority
follows queue pressure.

The control plane is the reference's, quirks included: a prompt is fed
token by token through the full-batch step; every slot shares one
position (the longest slot's), so a shorter slot attends to the
zero-filled rows between its own length and that position; a request
completes at ``max_new`` tokens or at ``max_len - 1``; a prompt of
``max_len`` tokens or more is dropped.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


class ServeScheduler:
    """Fixed-slot continuous batching over a single shared-length cache.

    All slots share one cache capacity (max_len) on the parameters'
    device.  Requests longer than the capacity are dropped.  ``gen``
    (a ``torch.Generator`` on that device) drives temperature sampling;
    greedy decoding draws nothing.
    """

    def __init__(self, cfg, fam, params, batch_slots: int, max_len: int,
                 temperature: float = 0.0, gen=None):
        from .decode import make_serve_step
        self.cfg, self.fam, self.params = cfg, fam, params
        self.device = params["tok_emb"].device
        self.slots = batch_slots
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * batch_slots
        self.lengths = np.zeros(batch_slots, np.int32)
        self.cache = fam["init_cache"](cfg, batch_slots, max_len,
                                       self.device)
        self._step = make_serve_step(cfg, fam, temperature)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.gen = gen
        self.completed: List[Request] = []

    def submit(self, req: Request):
        req.out = []
        self.queue.append(req)

    def _admit(self):
        """Fill empty slots; prefill the prompt token-by-token through the
        decode path (single shared cache keeps this simple and exercises
        the same serve_step)."""
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                if req.prompt.shape[0] >= self.max_len:
                    continue
                self.active[s] = req
                self.lengths[s] = 0
                # feed prompt tokens sequentially into this slot
                for t in req.prompt:
                    self.tokens[s, 0] = t
                    self._advance(only_slot=s)

    def _advance(self, only_slot: Optional[int] = None):
        pos = int(self.lengths.max()) if only_slot is None \
            else int(self.lengths[only_slot])
        nxt, _, self.cache = self._step(
            self.params, self.cache,
            torch.from_numpy(self.tokens).to(self.device),
            min(pos, self.max_len - 1), self.gen)
        nxt = nxt.cpu().numpy()
        if only_slot is not None:
            self.lengths[only_slot] += 1
            return nxt
        for s, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[s, 0])
            req.out.append(tok)
            self.tokens[s, 0] = tok
            self.lengths[s] += 1
            if (len(req.out) >= req.max_new
                    or self.lengths[s] >= self.max_len - 1):
                self.completed.append(req)
                self.active[s] = None
        return nxt

    def run(self, max_steps: int = 1000):
        steps = 0
        while (self.queue or any(a is not None for a in self.active)) \
                and steps < max_steps:
            self._admit()
            if any(a is not None for a in self.active):
                self._advance()
            steps += 1
        return self.completed
