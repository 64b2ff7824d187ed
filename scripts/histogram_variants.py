#!/usr/bin/env python3
"""Time design variants of ``histogram_bin`` on one CUDA card, at the
Histogram app's 524,288 bins.

    python3 scripts/histogram_variants.py [--probe] [variant ...]

The variants (``VARIANTS``): the committed design
(``kernels/csrc/histogram_bin.cu``: at these bins 16 slices of 32,768,
block b counting the ids of slice b mod 16 in its shared memory and
sending the others to global atomics), the same with two blocks an SM
(32 slices of 16,384) or with chunks of 8,192 ids in place of one
slice's worth; the global-atomic design it replaced
(``scripts/histogram_bin_global.cu``: one global atomic per id); the
thread-block-cluster design (``scripts/histogram_bin_cluster.cu``: the
bins spread over a 16-block cluster's distributed shared memory); and
the window-privatized count (``scripts/histogram_bin_window.cu``: each
chunk of ids counted into a shared-memory window at its least id, the
ids outside it sent to global atomics).  Each is built by ``nvcc`` into
``kernels/_build/histogram_variants/`` and called through its C
launcher (the committed design's through ``histogram_bin.launch``, which
also reports its plan and resident blocks).

Readings, made from seed 42: the paper's Histogram input on RMAT-22
(``(i + w_i) mod bins``: a warp's ids nearly distinct and neighbouring),
the RMAT-22 degree histogram (destination ids mod bins: hubs make hot
bins) and uniform random ids.  Per reading: every variant against the
plain version, bitwise; then its mean device milliseconds a call
(``chip_smoke.time_cuda``: CUDA events over 40 calls; one call reads
268 MB, more than twice the L2 cache) in turns, forward then backward
through the variants, beside the byte bound, ``torch.bincount`` and the
plain version.  Prints one JSON line per reading and the ``nvidia-smi``
name and power limit; exits nonzero if a variant disagrees (after every
reading is printed).
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                  # noqa: E402
from repro_torch.graph import rmat_edges                  # noqa: E402
from repro_torch.graph.rmat import histogram_input        # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.kernels import histogram_bin as hb       # noqa: E402

HERE = Path(__file__).resolve().parent
COMMITTED = _build.CSRC / "histogram_bin.cu"
OUT = _build.BUILD_DIR / "histogram_variants"
CHUNK = "path == kPathSliced ? per_block : kPrivateChunk;"
# name: (source, substitutions in it, plan in place of the card's own)
VARIANTS = {
    "global atomics": (HERE / "histogram_bin_global.cu", [], None),
    "sliced": (COMMITTED, [], None),
    "sliced, two blocks an SM": (COMMITTED, [],
                                 hb.Plan("sliced", 32, 16384, 65536)),
    "sliced, chunk 8192 ids": (COMMITTED, [(CHUNK, CHUNK.replace(
        "per_block :", "8192LL :"))], None),
    "cluster": (HERE / "histogram_bin_cluster.cu", [], None),
    "window 8192 bins": (HERE / "histogram_bin_window.cu", [], None),
}


def build(names):
    """{name: loaded library}, one ``nvcc`` each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        source, subs, _ = VARIANTS[name]
        text = source.read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {source.name}")
            text = text.replace(old, new)
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}",
             "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{log}")
        print(f"== {name}: ptxas\n" + "\n".join(
            line for line in log.splitlines() if "ptxas info" in line),
            flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def caller(name, lib):
    """f(idx, bins) -> f32 counts for one variant, and a function that
    gives its plan (None for the designs without one)."""
    source, _, plan = VARIANTS[name]
    if source == COMMITTED:
        def committed(idx, bins):
            return hb.launch(lib, idx, bins, plan)[0]
        return committed, lambda bins: hb.geometry(lib, bins, plan)
    fn = lib.histogram_bin_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def other(idx, bins):
        cnt = torch.empty((bins,), dtype=torch.int32, device=idx.device)
        out = torch.empty((bins,), dtype=torch.float32, device=idx.device)
        _build.launch(name, fn, idx.data_ptr(), cnt.data_ptr(),
                      out.data_ptr(), idx.numel(), bins,
                      torch.cuda.current_stream().cuda_stream)
        return out
    return other, lambda bins: None


def readings(dev):
    """(label, ids on the card, bins) of each reading."""
    g = rmat_edges(cs.SCALE, edge_factor=cs.EDGE_FACTOR, seed=cs.SEED)
    bins = g.n_rows // 8
    wl = {cs.SCALE: g, "bins": bins, "histo": histogram_input(g, bins)}
    out = [(label, torch.from_numpy(ids).to(dev), bins)
           for label, ids in cs.histogram_readings(wl).items()]
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    out.append(("uniform", torch.randint(0, bins, (g.nnz,), generator=gen,
                                         device=dev, dtype=torch.int32),
                bins))
    if "--probe" in sys.argv:
        out += probes(g.nnz, bins, gen, dev)
    return out


def probes(n, bins, gen, dev):
    """Synthetic readings that take the cluster design apart (16 owners
    of 32,768 bins; a block's chunk is 32,768 ids, and block r of a
    cluster takes chunks that are r mod 16, as a block of the sliced
    design does): every block sends its ids to one owner, its own or the
    next, into random or neighbouring bins."""
    per = bins // 16
    pos = torch.arange(n, device=dev, dtype=torch.int64)
    owner = pos // per % 16
    rand = torch.randint(0, per, (n,), generator=gen, device=dev)
    out = []
    for label, own, slot in (
            ("probe: own slice, random bins", owner, rand),
            ("probe: next block's slice, random bins", (owner + 1) % 16,
             rand),
            ("probe: next block's slice, neighbouring bins",
             (owner + 1) % 16, pos % per)):
        out.append((label, (own * per + slot).to(torch.int32), bins))
    return out


def measure(label, idx, bins, names, calls, plans):
    """Check every variant against the plain version, then time them in
    turns; prints the reading's JSON line and returns the names of the
    variants that disagreed."""
    want = hb.plain(idx, bins)
    wrong = []
    for n in names:
        got = calls[n](idx, bins)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            print(f"DISAGREES: {n} on {label} (max |err| "
                  f"{cs.max_abs_err(got, want)})", flush=True)
            wrong.append(n)
    sets = [(idx, bins)]
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cs.time_cuda(calls[n], sets))
    lib_ms = cs.time_cuda(lambda i, b: torch.bincount(i, minlength=b), sets)
    plain_ms = cs.time_cuda(hb.plain, sets)
    nbytes = 4 * idx.numel() + 4 * bins
    plan = {}
    for n in names:
        got = plans[n](bins)
        if got is not None:
            p, resident = got
            plan[n] = dict(path=p.path, slices=p.slices,
                           per_block=p.per_block, resident=resident)
    print(json.dumps(dict(
        reading=label, ids=idx.numel(), bins=bins, bytes=nbytes,
        bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3, bincount_ms=lib_ms,
        plain_ms=plain_ms, ms=ms, plan=plan,
        correct={n: n not in wrong for n in names})), flush=True)
    return wrong


def main() -> int:
    if not torch.cuda.is_available():
        print("histogram_variants: no CUDA device", file=sys.stderr)
        return 2
    names = [a for a in sys.argv[1:] if a != "--probe"] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    libs = build(names)
    calls, plans = {}, {}
    for n in names:
        calls[n], plans[n] = caller(n, libs[n])
    wrong = []
    for label, idx, bins in readings(dev):
        wrong += measure(label, idx, bins, names, calls, plans)
        del idx
    print(smi)
    if wrong:
        print(f"variants that disagreed: {sorted(set(wrong))}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
