"""Multi-pod dry run: count every (arch x shape x mesh) cell, the port of
``repro/launch/dryrun.py``.

For each cell this builds the real step function (the sharded train step
with its optimizer, the sharded prefill, or the sharded serve step),
places its inputs by ``launch/shardings.py``'s rules, and runs it once on
fake tensors (``FakeTensorMode``: shapes, dtypes and devices, no memory)
as rank 0 of a ``fake`` process group of the production grid's size,
16 x 16 single-pod and 2 x 16 x 16 multi-pod: every collective is issued
and moves nothing.  ``launch/opanalysis.py``'s ``StepCount`` counts the
call.  Success says the cell is coherent: every sharding divides, every
rank's blocks fit the step, and the counts give what a rank holds, its
FLOPs, its HBM bytes and its collective bytes by class.  The reference
lowers and compiles each cell with XLA; the port has no compiler, so its
counts are those of the ops it dispatches (the eager op is its kernel
boundary).  The step it counts computes data-parallel over the batch
axes; over ``model`` it is tensor-parallel for the dense family (each
rank computes on its blocks of the weights and of the cache, ROADMAP
A.10e-1) and replicated for the others (A.10e-2, A.10e-3), and the
counts say what each costs.

Artifacts (one JSON per cell) record the memory (this rank's blocks of
the inputs, its outputs, the peak of what the step allocates above them,
and whether they fit the card's 80 GB), the counted FLOPs and bytes, the
collective bytes and counts by class, the model FLOPs of the cell's
shapes, and the roofline terms with the H100 constants below.  Every
number is counted from shapes, none timed.

Usage:
  python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape \\
      train_4k --mesh single [--out artifacts/dryrun_torch] \\
      [--opt '{"q_chunk":512}'] [--device cpu]
  python -m repro_torch.launch.dryrun --all [--mesh both] [--device cpu]
  python -m repro_torch.launch.dryrun --arch deepseek-7b,pixtral-12b \
      [--shape train_4k,decode_32k] --mesh both --jobs 6 --device cpu

``--arch`` and ``--shape`` take comma-separated lists (``--shape``
left out: every shape).

The fake tensors lie on the card's device (``cuda``) unless ``--device
cpu`` is given, and the run raises without a card otherwise.  A build of
PyTorch without CUDA cannot run these steps on CUDA tensors, fake ones
included (its autograd and its views need the device's guard), so
there the dry run takes ``--device cpu``.  The counts do not depend on
the device: ``ops.decode_attention`` is one custom op on either,
counted by its formula, and no other op of these paths picks its route
by device (``tests/test_torch_gpu.py`` holds the two against each
other).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from .. import device as device_mod
from ..checkpoint.ckpt import flatten, unflatten
from ..core.collectives import make_grid
from ..models import layers, registry
from ..serving.decode import make_prefill, make_serve_step
from ..training import Shardings, TrainState, adafactor, adamw, make_train_step
from . import shapes as shp
from . import shardings as sh
from .mesh import make_production_mesh
from .opanalysis import StepCount

# ---------------------------------------------------------------- constants
# one NVIDIA H100 SXM, from NVIDIA's H100 data sheet (dense rates, no
# sparsity, at the 700 W power limit)
PEAK_FLOPS = 989e12          # bf16 FLOP/s on the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_CAPACITY = 80e9          # HBM bytes (80 GB)
NVLINK_BW = 450e9            # bytes/s a direction, NVLink 4 in an 8-GPU node
NET_BW = 50e9                # bytes/s a GPU across nodes (400 Gb/s InfiniBand)

DEFAULT_OUT = "artifacts/dryrun_torch"
GRIDS = dict(single=(16, 16), multi=(2, 16, 16))   # launch/mesh.py's

FSDP_ARCHS = {"starcoder2-3b", "starcoder2-15b", "deepseek-7b",
              "h2o-danube-3-4b", "pixtral-12b", "deepseek-v3-671b"}

_OPTS = ("q_chunk", "moe_group", "moe_cf", "carry_cache", "microbatches",
         "seq_parallel", "two_hop_dispatch", "ep_axes")


@contextlib.contextmanager
def overrides(opt_overrides):
    """The ``--opt`` overrides for the ``with`` block: ``q_chunk``,
    ``moe_group`` and ``moe_cf`` set ``models.layers``' knobs (restored
    after); ``carry_cache`` true is the port's in-place cache, false
    raises ``ValueError`` (no scan to double-buffer); ``microbatches``
    above 1 (A.10f), ``seq_parallel`` (A.10e-3), ``two_hop_dispatch``
    and ``ep_axes`` (expert parallelism, A.10e-2) raise
    ``NotImplementedError``; another key raises ``ValueError``."""
    opt = dict(opt_overrides or {})
    unknown = sorted(set(opt) - set(_OPTS))
    if unknown:
        raise ValueError(f"unknown --opt keys {unknown} (known: {_OPTS})")
    if int(opt.get("microbatches", 1)) > 1:
        raise NotImplementedError("microbatches under shardings are not "
                                  "ported yet (ROADMAP A.10f)")
    for key, item, what in (
            ("seq_parallel", "A.10e-3", "sequence parallelism"),
            ("two_hop_dispatch", "A.10e-2", "the MoE's expert parallelism"),
            ("ep_axes", "A.10e-2", "the MoE's expert parallelism")):
        if opt.get(key):
            raise NotImplementedError(
                f"{key}: {what} over 'model' is not ported yet (ROADMAP "
                f"{item})")
    if not opt.get("carry_cache", True):
        raise ValueError("carry_cache=False: the port's decode writes its "
                         "cache in place; it has no scan to double-buffer")
    saved = layers.DEFAULT_Q_CHUNK, layers.MOE_GROUP, layers.MOE_CF
    try:
        if opt.get("q_chunk"):
            layers.DEFAULT_Q_CHUNK = int(opt["q_chunk"])
        if "moe_group" in opt:
            layers.MOE_GROUP = int(opt["moe_group"])
        if "moe_cf" in opt:
            layers.MOE_CF = float(opt["moe_cf"])
        yield
    finally:
        layers.DEFAULT_Q_CHUNK, layers.MOE_GROUP, layers.MOE_CF = saved


def _blocks(tree, specs: dict, prefix: str, grid):
    """This rank's block of each leaf of ``tree`` (contiguous copies)."""
    return unflatten(tree, {
        k: t[sh.block_index(specs[prefix + k], t.shape, grid)].contiguous()
        for k, t in flatten(tree).items()})


def _cell(shape) -> shp.ShapeCell:
    return shape if isinstance(shape, shp.ShapeCell) else shp.SHAPES[shape]


def build_cell(arch: str, shape, grid, opt_overrides=None, *, device,
               smoke: bool = False, fsdp=None, optimizer=None):
    """(step function, this rank's arguments) of a cell on ``grid``;
    call it under a ``FakeTensorMode`` (the arguments are fake tensors on
    ``device``) and ``overrides(opt_overrides)``.  ``shape`` names a cell
    of ``SHAPES`` or is a ``ShapeCell``; ``fsdp`` (default: the arch is
    in ``FSDP_ARCHS``) and ``optimizer`` (default: Adafactor for
    ``mla_moe``, else AdamW) as the reference's ``build_cell`` picks
    them."""
    cfg, fam = registry.get(arch, smoke=smoke)
    cell = _cell(shape)
    fsdp = arch in FSDP_ARCHS if fsdp is None else fsdp
    params = shp.param_specs(cfg, fam, device)

    if cell.kind == "train":
        opt = optimizer or (adafactor() if cfg.family == "mla_moe"
                            else adamw())
        state = TrainState.create(params, opt)
        specs = sh.train_state_specs(state, grid, fsdp=fsdp)
        state = sh.place(state, specs, grid)
        batch = shp.batch_specs(cfg, cell, device)
        bspecs = sh.tree_specs(batch, sh.batch_spec, grid)
        step = make_train_step(cfg, fam, opt,
                               shardings=Shardings(grid, specs))
        return step, (state, _blocks(batch, bspecs, "", grid))

    if cell.kind == "prefill":
        batch = shp.batch_specs(cfg, cell, device)
        specs = sh.serve_specs(params, grid, batch=batch, fsdp=fsdp)
        fn = make_prefill(cfg, fam, shardings=Shardings(grid, specs))
        return fn, (_blocks(params, specs, ".params", grid),
                    _blocks(batch, specs, ".batch", grid))

    cache, tokens, pos, gen = shp.decode_specs(cfg, fam, cell, device)
    specs = sh.serve_specs(params, grid, batch=dict(tokens=tokens),
                           cache=cache, fsdp=fsdp)
    fn = make_serve_step(cfg, fam, shardings=Shardings(grid, specs))
    return fn, (_blocks(params, specs, ".params", grid),
                _blocks(cache, specs, ".cache", grid),
                _blocks(dict(tokens=tokens), specs, ".batch",
                        grid)["tokens"], pos, gen)


def _storages(tree) -> dict:
    """{storage key: bytes} of the tensors in ``tree`` (dicts, lists,
    tuples and dataclass nodes), each storage once."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in flatten(tree).values() if isinstance(t, torch.Tensor)}


def model_flops(cfg, cell) -> float:
    """(6 train, else 2) x active parameters x tokens: the reference's
    MODEL_FLOPS of the cell's shapes."""
    tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    return float((6 if cell.kind == "train" else 2)
                 * cfg.active_param_count() * tokens)


def roofline(counts: dict) -> dict:
    """The three roofline terms (s) of one rank's counts; a collective
    whose group spans nodes is charged at the network's rate."""
    link = counts["collective_link_bytes"]
    return dict(compute_s=counts["flops"] / PEAK_FLOPS,
                memory_s=counts["hbm_bytes"] / HBM_BW,
                collective_s=(link["within_node"] / NVLINK_BW
                              + link["across_nodes"] / NET_BW))


def count_cell(arch: str, shape, grid, opt_overrides=None, *, device,
               smoke: bool = False, fsdp=None, optimizer=None) -> dict:
    """The counts, memory and roofline of one cell on ``grid`` (this
    process's group must be the grid's), counted on fake tensors
    (``build_cell``'s arguments)."""
    cfg, _ = registry.get(arch, smoke=smoke)
    cell = _cell(shape)
    n_dev = int(np.prod(grid.shape))
    t0 = time.perf_counter()
    with overrides(opt_overrides), FakeTensorMode():
        fn, args = build_cell(arch, cell, grid, opt_overrides,
                              device=device, smoke=smoke, fsdp=fsdp,
                              optimizer=optimizer)
        held = _storages(args)
        with StepCount() as count:
            out = fn(*args)
        made = _storages(out)
        del fn, args, out
    trace_s = time.perf_counter() - t0
    c = count.summary()
    memory = dict(argument_size_in_bytes=sum(held.values()),
                  output_size_in_bytes=sum(made.values()),
                  alias_size_in_bytes=sum(v for k, v in made.items()
                                          if k in held),
                  temp_size_in_bytes=c["peak_bytes"])
    per_rank = memory["argument_size_in_bytes"] + c["peak_bytes"]
    mf = model_flops(cfg, cell)
    terms = roofline(c)
    return dict(
        arch=arch, shape=cell.name, status="ok", n_devices=n_dev,
        kind=cell.kind, grid=list(grid.shape), names=list(grid.names),
        device=str(device), smoke=smoke, trace_s=round(trace_s, 2),
        memory=memory, bytes_per_rank=per_rank,
        fits=per_rank <= HBM_CAPACITY,
        cost=dict(flops_per_device=float(c["flops"]),
                  bytes_per_device=float(c["hbm_bytes"])),
        ops=c["ops"],
        collectives=dict(bytes=c["collective_bytes"],
                         counts=c["collective_counts"],
                         total_bytes=c["collective_total_bytes"],
                         link_bytes=c["collective_link_bytes"]),
        model_flops_global=mf,
        counted_flops_global=float(c["flops"]) * n_dev,
        useful_flops_ratio=mf / max(float(c["flops"]) * n_dev, 1.0),
        roofline_terms_s=terms, dominant=max(terms, key=terms.get),
        opt_overrides=dict(opt_overrides or {}))


def run_cell(arch: str, shape_name, mesh_kind: str,
             out_dir: str = DEFAULT_OUT, opt_overrides=None, tag: str = "",
             *, device=None, smoke: bool = False, grid=None, fsdp=None,
             optimizer=None) -> dict:
    """One cell on the production grid of ``mesh_kind`` (``grid``, a
    (shape, names) pair, replaces it): this process joins a ``fake``
    default group of the grid's size as rank 0, counts the cell
    (``count_cell``), leaves the group and writes
    ``<arch>_<shape>_<mesh>[_<tag>].json`` into ``out_dir``.  Raises if
    a default group already exists."""
    cfg, _ = registry.get(arch, smoke=smoke)
    cell = _cell(shape_name)
    if not shp.applicable(cfg, cell.name):
        return dict(arch=arch, shape=cell.name, mesh=mesh_kind,
                    status="skipped",
                    reason="full-attention arch at 500k")
    if dist.is_initialized():
        raise RuntimeError("run_cell makes its own fake process group: a "
                           "default group already exists")
    dev = device_mod.resolve(device)
    shape = grid[0] if grid else GRIDS[mesh_kind]
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        g = (make_grid(*grid) if grid
             else make_production_mesh(multi_pod=mesh_kind == "multi"))
        result = count_cell(arch, cell, g, opt_overrides, device=dev,
                            smoke=smoke, fsdp=fsdp, optimizer=optimizer)
    finally:
        dist.destroy_process_group()
    result["mesh"] = mesh_kind
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}_{cell.name}_{mesh_kind}{('_' + tag) if tag else ''}"
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--opt", default=None,
                    help="JSON dict of optimization overrides")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors lie: the card (default) "
                         "or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    args = ap.parse_args(argv)
    overrides_ = json.loads(args.opt) if args.opt else None

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape, m) for arch in registry.ARCHS
                 for shape in shp.SHAPES for m in meshes]
    else:
        shapes = args.shape.split(",") if args.shape else list(shp.SHAPES)
        cells = [(arch, shape, m) for arch in args.arch.split(",")
                 for shape in shapes for m in meshes]

    t_all = time.perf_counter()
    if args.jobs > 1 and len(cells) > 1:
        failures = _run_in_processes(cells, args)
    else:
        failures = sum(not _run_and_print(arch, shape, m, args, overrides_)
                       for arch, shape, m in cells)
    if len(cells) > 1:
        print(f"{len(cells)} cells in {time.perf_counter() - t_all:.1f} s, "
              f"{failures} failed", flush=True)
    sys.exit(1 if failures else 0)


def _run_and_print(arch, shape, m, args, overrides_) -> bool:
    """Run one cell of the CLI and print its line; False if it failed."""
    name = f"{arch}_{shape}_{m}"
    path = os.path.join(args.out, name + ".json")
    if args.skip_existing and os.path.exists(path):
        print(f"[skip] {name}")
        return True
    try:
        r = run_cell(arch, shape, m, args.out, overrides_, args.tag,
                     device=args.device)
    except Exception as e:
        print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
        traceback.print_exc()
        return False
    if r["status"] == "skipped":
        print(f"[SKIP] {name}: {r['reason']}", flush=True)
        return True
    t = r["roofline_terms_s"]
    print(f"[ OK ] {name}: trace={r['trace_s']}s "
          f"flops/dev={r['cost']['flops_per_device']:.3g} "
          f"bytes/dev={r['cost']['bytes_per_device']:.3g} "
          f"coll={r['collectives']['total_bytes']:.3g}B "
          f"mem/dev={r['bytes_per_rank'] / 2**30:.1f}GiB "
          f"fits={r['fits']} dom={r['dominant']} "
          f"(c={t['compute_s']:.4f} m={t['memory_s']:.4f} "
          f"x={t['collective_s']:.4f}) "
          f"useful={r['useful_flops_ratio']:.4f}", flush=True)
    return True


def _run_in_processes(cells, args) -> int:
    """``--jobs N``: each cell in a process of its own (this CLI on one
    cell), N at a time; returns the failures."""
    import concurrent.futures
    import subprocess

    def one(cell):
        arch, shape, m = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", m, "--out", args.out]
        for flag, value in (("--opt", args.opt), ("--tag", args.tag),
                            ("--device", args.device)):
            if value:
                cmd += [flag, value]
        if args.skip_existing:
            cmd.append("--skip-existing")
        return subprocess.run(cmd, capture_output=True, text=True)

    failures = 0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        for proc in pool.map(one, cells):
            print(proc.stdout, end="", flush=True)
            if proc.returncode:
                failures += 1
                print(proc.stderr[-4000:], flush=True)
    return failures


if __name__ == "__main__":
    main()
