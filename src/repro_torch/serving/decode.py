"""Serving steps: prefill + single-token decode with sampling, the port
of ``repro/serving/decode.py``.

``serve_step`` is one new token against a KV cache, optimizer-free; in
the dense family each of its layers runs the ``decode_attention``
kernel once.  The steps run eagerly under ``torch.inference_mode()``.

With ``shardings=`` (a ``training.Shardings``: a grid and the specs of
``launch.shardings.serve_specs``) the steps are the counterpart of the
reference's ``jax.jit(prefill / serve, in_shardings=...)``
(``launch/dryrun.py``'s ``build_cell``): the parameters are this rank's
blocks by ``param_spec``, the batch (tokens) this rank's block along the
grid's batch axes where they cut it, and the cache this rank's blocks by
``cache_spec``.  A step
  (a) all-gathers each parameter over its spec's axes (the FSDP gather,
      as the sharded train step does),
  (b) all-gathers each cache leaf over the axes its spec names other
      than the batch axes on its batch dim (``model``), giving this
      rank's rows of the whole leaf; a leaf whose spec leaves its batch
      dim whole (xlstm's mLSTM states, whose batch is not on dim 1)
      holds every row, and the step reads this rank's rows of it,
  (c) runs the plain step on this rank's rows, with the MoE layer's
      batch grid set where the batch is cut (its groups are the global
      batch's, ``models.layers.batch_grid``),
  (d) returns this rank's blocks of the new cache: written back into
      the blocks it was given (the port's in-place cache), after the
      rows of a leaf held whole are all-gathered over the batch axes.
Compute is data-parallel over the batch axes and replicated over
``model``: every rank gathers each parameter and its rows of the cache
whole.  Tensor-parallel compute over ``model`` is ROADMAP A.10e.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from ..checkpoint.ckpt import flatten, unflatten
from ..launch import shardings as sh
from ..models import layers


def sample_logits(logits, gen=None, temperature: float = 0.0,
                  vocab: int = 0):
    """Greedy (T=0) or temperature sampling from ``gen`` (a
    ``torch.Generator`` on the logits' device).  logits: (B, V_pad);
    ``vocab`` masks the padding.  Returns (B,) int32."""
    if vocab:
        vids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(vids < vocab, logits,
                             torch.tensor(-torch.inf, dtype=logits.dtype,
                                          device=logits.device))
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def make_prefill(cfg, fam, shardings=None) -> Callable:
    """prefill(params, batch) -> (logits_last, cache).  With
    ``shardings`` (its specs' ``.params`` and ``.batch`` keys): the
    sharded prefill of the module's docstring, which returns this
    rank's logits and blocks of the cache."""
    if shardings is not None:
        return _sharded_prefill(cfg, fam, shardings)

    def prefill(params, batch):
        return fam["prefill"](params, batch, cfg)

    return prefill


def make_serve_step(cfg, fam, temperature: float = 0.0,
                    shardings=None) -> Callable:
    """serve_step(params, cache, tokens, pos, gen)
       -> (next_tokens, logits, cache).

    tokens: (B, 1) current token; pos: the absolute position (an int).
    With ``shardings`` (its specs' ``.params`` and ``.cache`` keys): the
    sharded step of the module's docstring, on this rank's blocks.
    """
    if shardings is not None:
        return _sharded_serve_step(cfg, fam, temperature, shardings)

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos, gen=None):
        logits, cache = fam["decode"](params, cache, tokens, pos, cfg)
        nxt = sample_logits(logits, gen, temperature, cfg.vocab)
        return nxt[:, None], logits, cache

    return serve_step


# ------------------------------------------------------------ sharded steps
def cache_batch_dims(cfg, fam) -> dict:
    """{cache key: its batch dim}: the dim that grows with the batch
    between two meta caches of the family (dim 1 of most leaves, dim 2
    of xlstm's mLSTM states)."""
    one = flatten(fam["init_cache"](cfg, 1, 1, device="meta"))
    two = flatten(fam["init_cache"](cfg, 2, 1, device="meta"))
    return {k: next(d for d, (a, b) in enumerate(zip(one[k].shape,
                                                     two[k].shape)) if a != b)
            for k in one}


class _Layout:
    """What a sharded serving step reads of its grid and specs."""

    def __init__(self, cfg, fam, shardings):
        self.grid, self.specs = shardings.grid, shardings.specs
        self.axes = sh.batch_axes(self.grid)
        sizes = dict(zip(self.grid.names, self.grid.shape))
        at = dict(zip(self.grid.names, self.grid.coords))
        self.rank, self.n = 0, 1
        for a in self.axes:
            self.rank, self.n = self.rank * sizes[a] + at[a], self.n * sizes[a]
        self.batch_dims = cache_batch_dims(cfg, fam)

    def cuts(self, entry) -> bool:
        return sh.names_only(entry, self.axes)

    def params(self, blocks):
        """(a): the full parameters."""
        return unflatten(blocks, {
            k: sh.gather_leaf(b, self.specs[".params" + k], self.grid)
            for k, b in flatten(blocks).items()})

    def batch_grid(self, cut: bool):
        return (layers.batch_grid(self.grid, self.axes) if cut
                else contextlib.nullcontext())

    def leaf(self, key, spec):
        """(this leaf's batch dim, whether its spec cuts that dim over
        the batch axes, its spec less that entry)."""
        dim = self.batch_dims[key]
        own = list(spec) + [None] * (dim + 1 - len(spec))
        cut = self.cuts(own[dim])
        if cut:
            own[dim] = None
        return dim, cut, tuple(own)

    def whole_rows(self, rows, dim):
        """Every rank's ``rows`` along ``dim`` over the batch axes."""
        spec = [None] * rows.dim()
        spec[dim] = sh._entry(self.axes)
        return sh.gather_leaf(rows.contiguous(), tuple(spec), self.grid)


def _sharded_prefill(cfg, fam, shardings) -> Callable:
    lay = _Layout(cfg, fam, shardings)
    cut = any(lay.cuts(e) for k, spec in lay.specs.items()
              if k.startswith(".batch") for e in spec)

    @torch.inference_mode()
    def prefill(params, batch):
        full = lay.params(params)                                   # (a)
        with lay.batch_grid(cut):                                   # (c)
            logits, cache = fam["prefill"](full, batch, cfg)
        del full
        blocks = {}
        for k, t in flatten(cache).items():                         # (d)
            dim = lay.batch_dims[k]
            shape = list(t.shape)
            shape[dim] *= lay.n if cut else 1
            spec = sh.cache_spec(".cache" + k, tuple(shape), lay.grid)
            dim, leaf_cut, own = lay.leaf(k, spec)
            if cut and not leaf_cut:
                t = lay.whole_rows(t, dim)
            blocks[k] = t[sh.block_index(own, t.shape, lay.grid)].contiguous()
        return logits, unflatten(cache, blocks)

    return prefill


def _sharded_serve_step(cfg, fam, temperature, shardings) -> Callable:
    lay = _Layout(cfg, fam, shardings)
    leaves = {k[len(".cache"):]: lay.leaf(k[len(".cache"):], spec)
              for k, spec in lay.specs.items() if k.startswith(".cache")}
    cut = any(c for _, c, _ in leaves.values())

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos, gen=None):
        full = lay.params(params)                                   # (a)
        blocks = flatten(cache)
        whole, rows = {}, {}
        for k, b in blocks.items():                                 # (b)
            dim, leaf_cut, own = leaves[k]
            whole[k] = sh.gather_leaf(b, own, lay.grid)
            rows[k] = whole[k]
            if cut and not leaf_cut:
                per = whole[k].shape[dim] // lay.n
                rows[k] = whole[k].narrow(dim, lay.rank * per, per)
        with lay.batch_grid(cut):                                   # (c)
            logits, new = fam["decode"](full, unflatten(cache, rows),
                                        tokens, pos, cfg)
        del full
        for k, t in flatten(new).items():                           # (d)
            dim, leaf_cut, own = leaves[k]
            if t is not rows[k]:
                rows[k].copy_(t)
            if cut and not leaf_cut:
                whole[k].copy_(lay.whole_rows(rows[k], dim))
            if whole[k] is not blocks[k]:
                blocks[k].copy_(whole[k][sh.block_index(own, whole[k].shape,
                                                        lay.grid)])
        nxt = sample_logits(logits, gen, temperature, cfg.vocab)
        return nxt[:, None], logits, cache

    return serve_step


@torch.inference_mode()
def generate(cfg, fam, params, batch, steps: int, temperature: float = 0.0,
             gen=None):
    """Host loop: prefill then ``steps`` decode steps (example/test path).
    Returns (B, steps) int32 tokens on the parameters' device."""
    from .kvcache import pad_cache
    prefill = make_prefill(cfg, fam)
    step = make_serve_step(cfg, fam, temperature)
    logits, cache = prefill(params, batch)
    cache = pad_cache(cfg, cache, steps)           # decode headroom
    tok = sample_logits(logits[:, -1], gen, temperature, cfg.vocab)[:, None]
    pos0 = batch["tokens" if "tokens" in batch else "embeds"].shape[1]
    out = [tok]
    for i in range(steps - 1):
        tok, _, cache = step(params, cache, tok, pos0 + i, gen)
        out.append(tok)
    return torch.cat(out, dim=1)
