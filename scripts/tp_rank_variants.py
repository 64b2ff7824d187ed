"""Phase 22 (b)'s production-grid decode ranks of one checkout, timed
several times: rank 0 of the 16 x 16 grid on a ``fake`` group with real
tensors on the card (``chip_smoke.production_rank``), for deepseek-7b's
heads-cut cache and starcoder2-3b's positions-cut cache at decode_32k.
These steps are host-bound and a host's speed varies between machines,
so two checkouts are compared in one run, in turns (A B B A), each in a
process of its own:

  python3 scripts/tp_rank_variants.py ROOT_A ROOT_B [--repeats 3]

A checkout's line is ``RANKS <root> {"arch": [ms, ...], ...}``.  Needs
one CUDA card; the kernels are built from each checkout's sources.
"""
import argparse
import json
import os
import subprocess
import sys

CELLS = (("deepseek-7b", "decode_32k"), ("starcoder2-3b", "decode_32k"))


def one(root: str, repeats: int) -> None:
    """Time every cell of ``root``'s port ``repeats`` times."""
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cs.build()
    out = {}
    for arch, shape in CELLS:
        out[arch] = [_ms(cs, dev, arch, shape) for _ in range(repeats)]
    print("RANKS", root, json.dumps(out), flush=True)


def _ms(cs, dev, arch, shape) -> float:
    """One timed step; the peak is not held here (phase 22 (b) holds
    it against the dry run's)."""
    require = cs.require
    cs.require = lambda ok, msg: None
    try:
        return cs.production_rank(dev, arch, shape, 1)[0]["ms"]
    finally:
        cs.require = require


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one, args.repeats)
        return 0
    if len(args.roots) != 2:
        ap.error("give two checkouts")
    a, b = (os.path.abspath(r) for r in args.roots)
    rc = 0
    for root in (a, b, b, a):
        rc |= subprocess.run([sys.executable, __file__, "--one", root,
                              "--repeats", str(args.repeats)],
                             timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
