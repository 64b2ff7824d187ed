"""Run a python snippet on ``n`` ranks of a gloo process group on the CPU
(the port's counterpart of ``tests/_subproc.py``).

Each rank is a ``python -c`` process with ``RANK``, ``WORLD_SIZE`` and
``OMP_NUM_THREADS=1``; the header puts ``src`` on the path, pins torch to
one thread and joins the group on a file store in a fresh temporary
directory, with an explicit timeout.  With ``group=False`` the snippet
joins it itself by calling ``init_group()`` (after work that must run
without a group).  The snippet runs with ``device="cpu"`` in mind: no
rank touches a card.

A rank aborted at exit ("terminate called without an active
exception", exit -6) in about one 4-rank spawn in four while another
spawn ran at once, and in a few in a hundred alone.  A barrier before
the footer destroys the group, and one spawn at a time on the machine
(an exclusive lock on a file in the temporary directory, held from the
spawn to the last rank's exit), made it rarer but did not end it: two
spawns at once without the lock still aborted 1 in 60 (and a
whole-suite run lost a module's fixture to it).  Markers printed to
stderr after the barrier and after ``destroy_process_group`` show that
it fires after both have returned, in the interpreter's own teardown of
torch's C++ state, with no thread of the port's running and every
group destroyed (the mesh test's snippet starts no thread and, at 4
ranks, makes no subgroup).  So the footer ends each rank there:
it flushes stdout and stderr and calls ``os._exit(0)``, which skips that
teardown.  A rank still exits 0 only when its whole snippet ran, and
``run_ranks`` still asserts every rank's exit code.
"""
import fcntl
import os
import subprocess
import sys
import tempfile
import time

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOCK = os.path.join(tempfile.gettempdir(), "repro_torch_ranks.lock")

HEADER = """\
import datetime
import os
import sys
import warnings
warnings.filterwarnings("ignore")
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])


def init_group():
    dist.init_process_group(
        "gloo", init_method="file://" + {store!r}, rank=RANK,
        world_size=WORLD, timeout=datetime.timedelta(seconds={timeout}))


"""
FOOTER = """
if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
"""


def run_ranks(snippet: str, n: int, timeout: int = 240,
              group: bool = True) -> list:
    """Run ``snippet`` on ``n`` ranks; returns each rank's stdout, in rank
    order.  Every rank must exit 0 within ``timeout`` seconds; past it
    every rank is killed and the call fails."""
    with open(LOCK, "a") as lock, \
            tempfile.TemporaryDirectory(prefix="torch_ranks_") as tmp:
        fcntl.flock(lock, fcntl.LOCK_EX)
        code = (HEADER.format(src=os.path.abspath(SRC),
                              store=os.path.join(tmp, "store"),
                              timeout=timeout)
                + ("init_group()\n" if group else "") + snippet + FOOTER)
        procs, outs = [], []
        for rank in range(n):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(n),
                       OMP_NUM_THREADS="1")
            out = open(os.path.join(tmp, f"out{rank}"), "w+")
            err = open(os.path.join(tmp, f"err{rank}"), "w+")
            outs.append((out, err))
            procs.append(subprocess.Popen([sys.executable, "-c", code],
                                          stdout=out, stderr=err, env=env))
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for out, err in outs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    for rank, (p, (out, err)) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, (
            f"rank {rank} of {n} failed (exit {p.returncode}):\n"
            f"STDOUT:\n{out}\nSTDERR:\n{err}")
    return [out for out, _ in texts]
