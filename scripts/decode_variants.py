#!/usr/bin/env python3
"""Time design variants of the tensor-core decode-attention kernel on one
CUDA card, at ``chip_smoke.py``'s decode_32k shapes.

    python3 scripts/decode_variants.py [variant ...]

Each variant is the committed ``kernels/csrc/decode_attention.cu`` with a
few of its constants or its split plan changed (``VARIANTS``), built by
``nvcc`` into ``kernels/_build/variants/`` and called through its C
launcher.  Per shape (bf16 inputs from ``chip_smoke.py``'s seed): every
variant against the plain version with lengths S and with ragged lengths
(rtol/atol 2e-2), then its device milliseconds (``chip_smoke.time_cuda``:
CUDA events over 40 calls, inputs rotated past L2) in turns, forward then
backward through the variants, beside the byte bound and
``scaled_dot_product_attention``.  Prints one JSON line per shape and the
``nvidia-smi`` name and power limit; fails on a variant that disagrees.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                  # noqa: E402
from repro_torch.kernels import _build                    # noqa: E402
from repro_torch.kernels import decode_attention as da    # noqa: E402

SOURCE = _build.CSRC / "decode_attention.cu"
OUT = _build.BUILD_DIR / "variants"
RING4 = [("constexpr int kTcStages = 3;", "constexpr int kTcStages = 4;"),
         ("__launch_bounds__(kTcThreads, 2)",
          "__launch_bounds__(kTcThreads, 1)")]
RING2 = [("constexpr int kTcStages = 3;", "constexpr int kTcStages = 2;"),
         ("__launch_bounds__(kTcThreads, 2)",
          "__launch_bounds__(kTcThreads, 3)")]
WARPS8 = [("constexpr int kTcTile = 64; ", "constexpr int kTcTile = 128;"),
          ("constexpr int kTcWarps = 4; ", "constexpr int kTcWarps = 8; "),
          ("__launch_bounds__(kTcThreads, 2)",
           "__launch_bounds__(kTcThreads, 1)")]
# name: (substitutions in the source, blocks a wave for the split plan)
VARIANTS = {
    "committed": ([], da.WAVE),
    "wave 264 (two blocks an SM)": ([], 2 * da.WAVE),
    "4-stage ring, one block an SM": (RING4, da.WAVE),
    "8 warps, 128-position tiles": (WARPS8, da.WAVE),
    "2-stage ring, three blocks an SM": (RING2, da.WAVE),
}


def plan(wave: int):
    """``da.split_plan`` with ``wave`` blocks a wave."""
    return lambda pairs, s: da.split_plan(pairs, s, wave)


def build(names):
    """{name: loaded library}, one ``nvcc`` each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    text, procs = SOURCE.read_text(), {}
    for i, name in enumerate(names):
        src = text
        for old, new in VARIANTS[name][0]:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} not in {SOURCE.name}")
            src = src.replace(old, new)
        cu, so = OUT / f"v{i}.cu", OUT / f"v{i}.so"
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: build failed\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def caller(lib, split_plan):
    fn = lib.decode_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] * 8
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, lengths):
        b, h, d = q.shape
        _, hkv, s, _ = k.shape
        splits, chunk = split_plan(b * hkv, s)
        ws_m = torch.empty((b, hkv, splits, h // hkv), device=q.device)
        ws_l = torch.empty_like(ws_m)
        ws_acc = torch.empty((b, hkv, splits, h // hkv, d), device=q.device)
        out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
        _build.launch("decode_attention variant", fn, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                      out.data_ptr(), None, ws_m.data_ptr(), ws_l.data_ptr(),
                      ws_acc.data_ptr(), b, h, hkv, s, d, splits, chunk,
                      -(-s // 512) * 512, int(q.dtype == torch.bfloat16),
                      1.0 / math.sqrt(d),
                      torch.cuda.current_stream().cuda_stream)
        return out
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    libs = build(names)
    calls = {n: caller(libs[n], plan(VARIANTS[n][1])) for n in names}
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    s = cs.DECODE_S
    for label, b, h, hkv, d in cs.DECODE_SHAPES:
        q = (torch.randn((b, h, d), generator=gen, device=dev)
             * cs.DECODE_Q_STD).to(torch.bfloat16)
        k, v = (torch.randn((b, hkv, s, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        full = torch.full((b,), s, dtype=torch.int32, device=dev)
        ragged = torch.randint(0, s + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        ragged[:4] = torch.tensor([0, 1, s, s + 100], dtype=torch.int32,
                                  device=dev)[:b]
        errs = {n: 0.0 for n in names}
        for lens in (full, ragged):
            want = cs.plain_by_slices(q, k, v, lens).float()
            for n in names:
                got = calls[n](q, k, v, lens).float()
                if not torch.allclose(got, want, rtol=cs.DECODE_TOL,
                                      atol=cs.DECODE_TOL):
                    raise SystemExit(f"{n} at {label}: outside "
                                     f"{cs.DECODE_TOL}")
                errs[n] = max(errs[n], cs.max_abs_err(got, want))
            del want
        nbytes = (q.numel() + k.numel() + v.numel() + b * h * d) * 2 + 4 * b
        args = cs.copies((q, k, v, full), nbytes)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(cs.time_cuda(calls[n], args))
        del args
        sdpa_ms, backend, sdpa_out = cs.sdpa_library(q, k, v, full,
                                                     1.0 / math.sqrt(d))
        del sdpa_out
        print(json.dumps(dict(
            shape=label, B=b, H=h, Hkv=hkv, D=d,
            bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3, library_ms=sdpa_ms,
            library_backend=backend, ms=ms, max_abs_err=errs)), flush=True)
        del q, k, v, full, ragged
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
