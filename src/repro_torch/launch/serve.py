"""Serving CLI: continuous batching over a reduced model, the port of
``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
      --smoke --requests 6 --slots 2 --max-new 8

Runs on the CUDA card; ``main(argv, device="cpu")`` runs it on the CPU.
Serves every registered arch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import device as device_mod
from ..models import registry
from ..serving.scheduler import Request, ServeScheduler


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    dev = device_mod.resolve(device)
    cfg, fam = registry.get(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = fam["init"](cfg, gen, dev)
    sched = ServeScheduler(cfg, fam, params, batch_slots=args.slots,
                           max_len=args.max_len,
                           temperature=args.temperature, gen=gen)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=rng.integers(3, 10)).astype(np.int32)
        sched.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    done = sched.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/max(dt,1e-9):.1f} tok/s) on {dev}")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4].tolist()} "
              f"-> {r.out[:6]}")
    return done


if __name__ == "__main__":
    main()
