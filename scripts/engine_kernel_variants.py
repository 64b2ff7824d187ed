#!/usr/bin/env python3
"""Time design variants of ``segment_combine`` and ``deliver_fused`` on
one CUDA card, at ``chip_smoke.py``'s phase-4 shapes and on the ids the
engine itself hands them.

    python3 scripts/engine_kernel_variants.py [--no-engine] [variant ...]

The variants (``VARIANTS``): the committed one-launch design
(``kernels/csrc/engine_kernels.cu``: segment_combine folds runs within a
warp where a thread takes more than one batch, deliver_fused never),
the same with the records a thread takes changed, with segment_combine's
fold always on or always off, with deliver_fused folding by
segment_combine's rule, or with both folding every repeat in a warp
through ``__match_any_sync`` in place of runs of neighbours; and the
multi-launch design it replaced (``scripts/engine_kernels_multilaunch.cu``:
fill + scatter, and copy + scatter + count conversion).  Each is built by
``nvcc`` into ``kernels/_build/engine_variants/`` and called through its
C launcher.

Readings: the synthetic inputs of ``chip_smoke.kernel_inputs`` (seed 42),
one call each; then, unless ``--no-engine``, the engine's own calls:
BFS, SpMV and Histogram at RMAT-22 on 4096 tiles run as
``chip_smoke.py``'s main path runs them, with ``chip_smoke.EngineIds``
keeping the inputs of every ``KEEP``-th call of each call shape (its
first included) and printing how the ids fall in warp slices.  Per
reading: every variant on every kept call against the plain version (min
bitwise, counts exact, add within rtol 1e-5 / atol 1e-6), then its mean
device milliseconds a call (``chip_smoke.time_cuda``: CUDA events,
inputs rotated past L2) in turns, forward then backward through the
variants, beside the byte bound.  Prints one JSON line per reading and
the ``nvidia-smi`` name and power limit; exits nonzero if a variant
disagrees (after every reading is printed).
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
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.kernels import deliver_fused as df       # noqa: E402
from repro_torch.kernels import segment_combine as sc     # noqa: E402

COMMITTED = _build.CSRC / "engine_kernels.cu"
MULTILAUNCH = Path(__file__).resolve().parent / "engine_kernels_multilaunch.cu"
OUT = _build.BUILD_DIR / "engine_variants"
KEEP = 500                 # engine readings: every KEEP-th call of a shape
ITEMS = "constexpr int kItemsPerThread = 4;"
FOLD_RULE = "const bool fold = a.n > kItemsPerThread * grid_stride();"
FOLD_ALWAYS = (FOLD_RULE, "const bool fold = true;")
NO_FOLD = (FOLD_RULE, "const bool fold = false;")
DELIVER = "scatter_batched(a.seg, a.val, a.n, a.nd, a.is_min, false,"
DELIVER_FOLD = (DELIVER, DELIVER.replace(
    "false,", "a.n > kItemsPerThread * grid_stride(),"))
FOLD = "template <typename Leader>\n__device__ __forceinline__ void fold_runs("
# the fold of every repeat in a warp slice, neighbours or not: the lanes
# of one id from __match_any_sync, folded in a tree over their lanes
MATCH_ANY_FOLD = """template <typename Leader>
__device__ __forceinline__ void fold_runs(int s, float v, bool is_min,
                                          bool, Leader leader) {
  const int lane = threadIdx.x & 31;
  if (!__any_sync(kFullWarp, s >= 0)) return;
  unsigned peers = __match_any_sync(kFullWarp, s);
  if (s < 0) peers = 1u << lane;
  int rank = __popc(peers & ((1u << lane) - 1));
  unsigned above = peers & (0xfffffffeu << lane);
  int k = order_key(v);
  float x = v;
  while (__any_sync(kFullWarp, above != 0)) {
    const int next = __ffs(above);
    const int src = (next - 1) & 31;
    if (is_min) {
      const int y = __shfl_sync(kFullWarp, k, src);
      if (next) k = min(k, y);
    } else {
      const float y = __shfl_sync(kFullWarp, x, src);
      if (next) x += y;
    }
    above &= ~__ballot_sync(kFullWarp, rank & 1);
    rank >>= 1;
  }
  if (s >= 0 && (peers & ((1u << lane) - 1)) == 0) {
    leader(s, is_min ? key_float(k) : x, __popc(peers));
  }
}
"""


def _function(text: str, head: str) -> str:
    """The whole definition that starts with ``head`` in ``text``."""
    start = text.index(head)
    return text[start:text.index("\n}\n", start) + 3]


MATCH_ANY = (_function(COMMITTED.read_text(), FOLD), MATCH_ANY_FOLD)
# name: (source, substitutions in it)
VARIANTS = {
    "multi-launch": (MULTILAUNCH, []),
    "one launch": (COMMITTED, []),
    "one launch, 1 item a thread": (
        COMMITTED, [(ITEMS, ITEMS.replace("4;", "1;"))]),
    "one launch, 8 items a thread": (
        COMMITTED, [(ITEMS, ITEMS.replace("4;", "8;"))]),
    "one launch, 16 items a thread": (
        COMMITTED, [(ITEMS, ITEMS.replace("4;", "16;"))]),
    "one launch, segment fold always": (COMMITTED, [FOLD_ALWAYS]),
    "one launch, no segment fold": (COMMITTED, [NO_FOLD]),
    "one launch, deliver folds by the rule": (COMMITTED, [DELIVER_FOLD]),
    "one launch, __match_any_sync fold always": (COMMITTED, [MATCH_ANY]),
}


def build(names):
    """{name: loaded library}, one ``nvcc`` each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        source, subs = VARIANTS[name]
        text = source.read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {source.name}")
            text = text.replace(old, new)
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def callers(name, lib):
    """(segment_combine, deliver_fused) of one variant, with the package
    wrappers' signatures."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    seg_fn = lib.segment_combine_launch
    seg_fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
    seg_fn.restype = ctypes.c_int
    multi = VARIANTS[name][0] == MULTILAUNCH
    del_fn = lib.deliver_fused_launch
    del_fn.argtypes = ([ctypes.c_void_p] * (6 if multi else 5)
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_int] * (1 if multi else 2)
                       + [ctypes.c_void_p])
    del_fn.restype = ctypes.c_int

    def segment(seg, val, num_segments, combine="min"):
        out = torch.empty((num_segments,), device=seg.device)
        _build.launch(name, seg_fn, seg.data_ptr(), val.data_ptr(),
                      out.data_ptr(), seg.numel(), num_segments,
                      int(combine == "min"), stream())
        return out

    def deliver(seg, val, mail, combine="min"):
        n, nd = seg.numel(), mail.numel()
        out = torch.empty_like(mail)
        cnt = torch.empty_like(mail)
        if multi:
            scratch = torch.empty((nd,), dtype=torch.int32,
                                  device=mail.device)
            _build.launch(name, del_fn, seg.data_ptr(), val.data_ptr(),
                          mail.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                          cnt.data_ptr(), n, nd, int(combine == "min"),
                          stream())
            return out, cnt
        _build.launch(name, del_fn, seg.data_ptr(), val.data_ptr(),
                      mail.data_ptr(), out.data_ptr(), cnt.data_ptr(), n, nd,
                      int(combine == "min"),
                      int(df.counting_path(n) == "i32"), stream())
        return out, cnt
    return segment, deliver


def readings(x):
    """Synthetic readings: (label, kernel, combine, [inputs])."""
    return [
        ("segment_combine min, P$ (sorted)", "segment", "min", [x["seg"]]),
        ("segment_combine add, P$ (sorted)", "segment", "add", [x["seg"]]),
        ("segment_combine add, flush wave (sorted)", "segment", "add",
         [x["seg_add"]]),
        ("segment_combine min, unsorted", "segment", "min", [x["seg_rand"]]),
        ("deliver_fused min, BFS shapes", "deliver", "min", [x["deliver"]]),
        ("deliver_fused add, BFS shapes", "deliver", "add", [x["deliver"]]),
        ("deliver_fused add, flush wave", "deliver", "add",
         [x["deliver_add"]]),
    ]


def engine_readings(dev):
    """Readings on the engine's own calls: the main path's RMAT-22 apps
    run through the package (kernels backend), every KEEP-th call of each
    call shape kept."""
    wl = cs.workloads()
    out = []
    for app, (fn, args, kw) in cs.main_path_apps(wl).items():
        with cs.EngineIds(keep=KEEP) as ids:
            fn(*args, device=dev, **kw)
        torch.cuda.synchronize()
        ids.report(app)
        for (name, combine, n, limit), kept in sorted(ids.kept.items()):
            out.append((f"{app}: {name} {combine}, {n} records into "
                        f"{limit} (engine ids, {len(kept)} of "
                        f"{ids.calls[name, combine, n, limit]} calls)",
                        "segment" if name == "segment_combine" else "deliver",
                        combine, kept))
    return out


def call_bytes(kernel, args) -> int:
    """Bytes the function must move on these inputs: every id, each live
    record's value, the outputs once (deliver_fused: the mailbox read,
    values and counts written)."""
    seg, _, third = args
    n_out = third if kernel == "segment" else 3 * third.numel()
    return cs._bytes_scatter(seg, 4 * n_out)


def rotation(calls_args, nbytes):
    """The calls' inputs, cloned round until one pass through them
    streams more than twice the L2 cache."""
    sets = list(calls_args)
    while nbytes * len(sets) < 2 * cs.L2_BYTES:
        sets += [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                       for a in args) for args in calls_args]
    return sets


def measure(label, kernel, combine, calls_args, names, calls, plain):
    """Check every variant on every call against the plain version, then
    time them in turns; prints the reading's JSON line and returns the
    names of the variants that disagreed."""
    errs, wrong = {n: 0.0 for n in names}, []
    for args in calls_args:
        want = plain[kernel](*args, combine)
        for n in names:
            got = calls[n][kernel](*args, combine)
            torch.cuda.synchronize()
            try:
                errs[n] = max(errs[n], cs._agree(
                    f"{n}: {label}", combine == "min", got, want,
                    cs.ADD_RTOL, cs.ADD_ATOL))
            except cs.SmokeFailure as e:
                print(f"DISAGREES: {e}", flush=True)
                wrong.append(n)
    nbytes = sum(call_bytes(kernel, a) for a in calls_args) / len(calls_args)
    sets = rotation(calls_args, nbytes)
    iters = len(sets) * -(-40 // len(sets))
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cs.time_cuda(
            lambda *a, f=calls[n][kernel]: f(*a, combine), sets, iters))
    plain_ms = cs.time_cuda(lambda *a: plain[kernel](*a, combine), sets,
                            iters)
    live = sum(int((a[0] >= 0).sum()) for a in calls_args) / len(calls_args)
    print(json.dumps(dict(
        reading=label, calls=len(calls_args),
        records=int(calls_args[0][0].numel()), live=live, bytes=nbytes,
        bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3, plain_ms=plain_ms,
        ms=ms, max_abs_err=errs)), flush=True)
    return wrong


def main() -> int:
    if not torch.cuda.is_available():
        print("engine_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    engine = "--no-engine" not in argv
    names = [a for a in argv if a != "--no-engine"] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cs.build()
    libs = build(names)
    calls = {n: dict(zip(("segment", "deliver"), callers(n, libs[n])))
             for n in names}
    plain = dict(segment=sc.plain, deliver=df.plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    todo = readings(cs.kernel_inputs(gen, dev))
    if engine:
        todo += engine_readings(dev)
    wrong = []
    for reading in todo:
        wrong += measure(*reading, names, calls, plain)
    print(smi)
    if wrong:
        print(f"variants that disagreed: {sorted(set(wrong))}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
