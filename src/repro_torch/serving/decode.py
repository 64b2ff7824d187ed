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
``port_cache_spec`` (the reference's placement: a rank holds the heads,
or the positions, the reference's rank holds).  A step
  (a) all-gathers each parameter over its spec's axes (the FSDP gather,
      as the sharded train step does), except ``model`` for the leaves
      the family computes on in their ``model`` blocks
      (``models.lm.TP_LEAVES``, the dense family's),
  (b) all-gathers each cache leaf over the axes its spec names other
      than the batch axes on its batch dim (``model``; never for the
      dense family, which computes on its block), giving this rank's
      rows of the leaf; a leaf whose spec leaves its batch dim whole
      (xlstm's mLSTM states, whose batch is not on dim 1) holds every
      row, and the step reads this rank's rows of it,
  (c) runs the plain step on this rank's rows, with the MoE layer's
      batch grid set where the batch is cut (its groups are the global
      batch's, ``models.layers.batch_grid``) and, for the dense family,
      the ``model`` grid (``models.layers.model_grid``): each layer on
      the rank's blocks of its weights and its KV heads, or its block
      of positions with the blocks' attention merged by their
      log-sum-exp, the logits all-gathered over ``model``,
  (d) returns this rank's blocks of the new cache: written back into
      the blocks it was given (the port's in-place cache), after the
      rows of a leaf held whole are all-gathered over the batch axes.
Compute is data-parallel over the batch axes; over ``model`` it is
tensor-parallel for the dense family and replicated for the others,
each rank gathering each parameter and its rows of the cache whole
(ROADMAP A.10e-2, A.10e-3).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..checkpoint.ckpt import flatten, unflatten
from ..launch import shardings as sh
from ..models import layers
from ..models.lm import TP_LEAVES


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
        # the leaves computed on in their 'model' blocks (tensor parallel)
        self.tp_names = (TP_LEAVES.get(cfg.family, ())
                         if "model" in self.grid.names else ())
        self.m = int(sizes.get("model", 1))
        # the K leaf (L, B, Hkv, T, D) of one row and one position
        self.k_one = (tuple(flatten(fam["init_cache"](
            cfg, 1, 1, device="meta"))["['k']"].shape)
            if self.tp_names else None)

    def cuts(self, entry) -> bool:
        return sh.names_only(entry, self.axes)

    def gather_spec(self, key, spec):
        """The axes a step gathers a leaf over: its spec, less ``model``
        where the step computes on the leaf's ``model`` block (a
        tensor-parallel parameter, and every cache leaf under TP)."""
        tp = key.startswith(".cache") or sh._name(key) in self.tp_names
        return sh.drop_axis(spec, "model") if self.tp_names and tp else spec

    def params(self, blocks):
        """(a): the parameters as the step computes on them."""
        return unflatten(blocks, {
            k: sh.gather_leaf(b, self.gather_spec(
                ".params" + k, self.specs[".params" + k]), self.grid)
            for k, b in flatten(blocks).items()})

    def batch_grid(self, cut: bool):
        return (layers.batch_grid(self.grid, self.axes) if cut
                else contextlib.nullcontext())

    def model_grid(self, kv_cut: str):
        return (layers.model_grid(self.grid, kv_cut) if self.tp_names
                else contextlib.nullcontext())

    def kv_cut(self, spec) -> Optional[str]:
        """What a rank holds of the K / V cache whose ``['k']`` leaf has
        ``spec`` (``shardings.kv_cut``), under tensor-parallel compute;
        else None.  The one place a step works the cache's cut out."""
        return sh.kv_cut(spec) if self.tp_names else None

    def prefill_kv_cut(self, batch, cut: bool) -> Optional[str]:
        """``kv_cut`` of the cache a prefill of ``batch`` makes: the spec
        of the family's whole K leaf for its rows and positions."""
        if not self.tp_names:
            return None
        x = batch
        if isinstance(batch, dict):
            x = batch["tokens"] if "tokens" in batch else batch["embeds"]
        shape = list(self.k_one)
        shape[1], shape[3] = x.shape[0] * (self.n if cut else 1), x.shape[1]
        return self.kv_cut(sh.port_cache_spec(".cache['k']", tuple(shape),
                                              self.grid))

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
        kv_cut = lay.prefill_kv_cut(batch, cut)
        with lay.batch_grid(cut), lay.model_grid(kv_cut):           # (c)
            logits, cache = fam["prefill"](full, batch, cfg)
        del full
        blocks = {}
        for k, t in flatten(cache).items():                         # (d)
            dim = lay.batch_dims[k]
            shape = list(t.shape)
            shape[dim] *= lay.n if cut else 1
            # cut on heads, the layers made only this rank's KV heads
            held = kv_cut == "heads" and sh._name(k) in sh.KV_LEAVES
            if held:
                shape[2] *= lay.m
            spec = sh.port_cache_spec(".cache" + k, tuple(shape), lay.grid)
            dim, leaf_cut, own = lay.leaf(k, spec)
            if held:
                own = sh.drop_axis(own, "model")
            if cut and not leaf_cut:
                t = lay.whole_rows(t, dim)
            blocks[k] = t[sh.block_index(own, t.shape, lay.grid)].contiguous()
        return logits, unflatten(cache, blocks)

    return prefill


def _sharded_serve_step(cfg, fam, temperature, shardings) -> Callable:
    lay = _Layout(cfg, fam, shardings)
    leaves = {}
    for key, spec in lay.specs.items():
        if key.startswith(".cache"):
            dim, leaf_cut, own = lay.leaf(key[len(".cache"):], spec)
            leaves[key[len(".cache"):]] = (dim, leaf_cut,
                                           lay.gather_spec(key, own))
    cut = any(c for _, c, _ in leaves.values())
    kv_cut = lay.kv_cut(lay.specs.get(".cache['k']", ()))

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
        with lay.batch_grid(cut), lay.model_grid(kv_cut):           # (c)
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
