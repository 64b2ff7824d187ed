"""End-to-end training launcher, the port of ``repro/launch/train.py``.

Trains any registered arch (reduced or custom-scaled config) on the
synthetic LM stream, with checkpointing and the fault-tolerant
loop under ``--ckpt-dir``; ``mla_moe`` (deepseek-v3) with Adafactor,
the others with AdamW.

  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --smoke --steps 25 --batch 8 --seq 32 --lr 3e-3 --log-every 10

Runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU.
Parameters are drawn from a ``torch.Generator`` on the device seeded 0:
the reference's shapes, dtypes and scales, not its values.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from .. import device as device_mod
from ..data.pipeline import to_device
from ..data.synthetic import SyntheticLM
from ..models import registry
from ..training.optimizer import adafactor, adamw, tree_leaves
from ..training.train_step import TrainState, make_train_step


def scale_config(cfg, d_model=None, n_layers=None, vocab=None):
    """Scale a registered config (e.g. to ~100M params for examples)."""
    kw = {}
    if d_model:
        ratio = d_model / cfg.d_model
        kw.update(d_model=d_model,
                  d_ff=max(64, int(cfg.d_ff * ratio) // 64 * 64)
                  if cfg.d_ff else 0,
                  head_dim=max(16, d_model // max(cfg.n_heads, 1)))
    if n_layers:
        kw["n_layers"] = n_layers
    if vocab:
        kw["vocab"] = vocab
    return dataclasses.replace(cfg, **kw)


def make_optimizer(cfg, lr: float, warmup: int):
    """The reference's choice: Adafactor for ``mla_moe``, else AdamW."""
    return adafactor(lr=lr, warmup=warmup) if cfg.family == "mla_moe" \
        else adamw(lr=lr, warmup=warmup)


def batch_source(cfg, seq: int, batch: int):
    """``(src, batch_at)``: the synthetic stream for ``cfg`` and the
    step -> host batch (numpy) the reference's loop feeds, with the
    keys its family reads."""
    src = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch,
                      d_model=cfg.d_model if cfg.input_embeds
                      or cfg.family == "encdec" else 0)

    def batch_at(i):
        b = src.batch_at(i)
        if cfg.family == "encdec":
            dec = min(b["tokens"].shape[1], 448)
            return dict(embeds=b["embeds"], tokens=b["tokens"][:, :dec],
                        labels=b["labels"][:, :dec])
        if cfg.input_embeds:
            return dict(embeds=b["embeds"], labels=b["labels"])
        return dict(tokens=b["tokens"], labels=b["labels"])

    return src, batch_at


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=0,
                    help="lr warmup steps; 0 = auto (steps//10, capped at "
                         "100) so short smoke runs are not spent entirely "
                         "inside the ramp")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=5)
    args = ap.parse_args(argv)

    dev = device_mod.resolve(device)
    cfg, fam = registry.get(args.arch, smoke=args.smoke)
    if args.d_model or args.n_layers or args.vocab:
        cfg = scale_config(cfg, args.d_model or None, args.n_layers or None,
                           args.vocab or None)
    n_params_est = cfg.param_count()
    ndev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"arch={cfg.arch} family={cfg.family} ~{n_params_est/1e6:.1f}M "
          f"params, {ndev} device(s)")

    warmup = args.warmup or min(100, max(1, args.steps // 10))
    opt = make_optimizer(cfg, args.lr, warmup)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fam["init"](cfg, gen, dev)
    real = sum(x.numel() for x in tree_leaves(params))
    print(f"initialized {real/1e6:.1f}M params")
    state = TrainState.create(params, opt)
    step_fn = make_train_step(cfg, fam, opt, microbatches=args.microbatches)
    _, host_batch = batch_source(cfg, args.seq, args.batch)

    def batch_at(i):
        return to_device(host_batch(i), dev)

    if args.ckpt_dir:
        from ..runtime.fault import FaultTolerantLoop
        loop = FaultTolerantLoop(step_fn, batch_at, args.ckpt_dir,
                                 ckpt_every=args.ckpt_every)
        state, history = loop.run(state, args.steps)
        losses = [float(h["loss"]) for h in history]
    else:
        losses = []
        t0 = time.time()
        for i in range(args.steps):
            state, metrics = step_fn(state, batch_at(i))
            losses.append(float(metrics["loss"]))
            if i % args.log_every == 0 or i == args.steps - 1:
                dt = time.time() - t0
                print(f"step {i:4d} loss={losses[-1]:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"({dt/(i+1):.2f}s/step)", flush=True)
    print(f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"(drop {(losses[0]-losses[-1]):.4f})")
    return losses


if __name__ == "__main__":
    main()
