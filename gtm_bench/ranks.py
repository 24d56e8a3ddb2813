"""A cell whose ``chips`` is N > 1 runs as an SPMD mesh of N ranks, one
process a card, started as ``torchrun --standalone --nproc-per-node N``
starts them: ``torch.distributed``'s elastic launcher on this host, with
no restarts (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each rank's environment).

Each rank runs :func:`rank_main`. It starts the default process group
itself, with a timeout (``parallel.mesh.init_process_group`` then leaves
it as it is): NCCL on the cards, one card a rank, or gloo on the CPU for
the tests. It builds its mesh with the port's own ``resolve_mesh("auto")``,
one ``corpus`` axis. Every rank runs the same encodes in lockstep
(``window.run``'s ``agree``); rank 0 alone owns the window's clock, the
capture, the stream, the profiler's breakdown, the judge and the result,
which the launcher hands back. No rank writes to standard output. When a
rank fails the launcher stops the others and raises, since a rank that
raised leaves them inside a collective; the group's timeout ends a rank
that waits in one longer.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 120  # a collective that waits longer ends its rank


def launch(job: dict, n: int):
    """Runs :func:`rank_main` on ``n`` ranks and returns rank 0's return
    value; raises SystemExit(1) where a rank fails, every rank stopped.
    On the cards the kernels are built once, before the ranks start."""
    if job["device"] == "cuda":
        from tiler_tpu_torch import native
        from tiler_tpu_torch.kernels import _build

        _build.build()
        native.get_lib()
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError
    from torch.distributed.launcher.api import LaunchConfig, elastic_launch

    config = LaunchConfig(min_nodes=1, max_nodes=1, nproc_per_node=n, run_id="gtm_bench",
                          rdzv_backend="c10d", rdzv_endpoint="localhost:0", max_restarts=0,
                          local_addr="127.0.0.1")
    try:
        return elastic_launch(config, rank_main)(job)[0]
    except ChildFailedError as e:
        print(f"{e.format_msg()}\nrank(s) {sorted(e.failures)} failed; every rank is stopped",
              file=sys.stderr, flush=True)
        raise SystemExit(1) from None


def run_mesh(c: dict, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
             plants=(), since: float | None = None) -> tuple[dict, list]:
    """One run of the mesh cell ``c`` (``run.load_cell``) over its
    ``chips`` ranks: (result line, lines for standard error), as
    ``run.run_cell`` returns them. ``device="cpu"`` (gloo) serves the
    tests; ``plants``: names in ``faults.PLANTS``, planted in every rank;
    ``since``: the wall time set-up counts from."""
    job = {"kind": "run", "cell": c, "seed": seed, "seconds": seconds, "trace": trace_on,
           "device": device, "plants": list(plants),
           "since": time.time() if since is None else since}
    return launch(job, c["cell"]["chips"])


class Group:
    """This rank's place in the mesh: its rank, the world's size, the
    DeviceMesh, and the collectives the harness itself takes."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()

    def agree(self, go: bool) -> bool:
        """Rank 0's ``go`` on every rank."""
        import torch.distributed as dist

        obj = [go]
        dist.broadcast_object_list(obj, src=0)
        return obj[0]

    def gather(self, obj) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out


def start_group(device: str) -> Group:
    """The default process group, with :data:`GROUP_TIMEOUT_S`, and the
    port's mesh over it: NCCL and this rank's card, or gloo on the CPU."""
    import torch
    import torch.distributed as dist

    from tiler_tpu_torch.pipeline.encoder import resolve_mesh

    if device == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return Group(resolve_mesh("auto", device))


def rank_main(job: dict):
    """One rank of ``job``: a run (``run.run_cell``), whose rank 0 returns
    (line, lines), or control readings (``control.readings``), whose rank
    0 returns the records, each also written to ``job["out"]`` as it
    comes. The other ranks return None."""
    os.dup2(2, 1)  # whatever a rank prints goes to standard error
    from gtm_bench import control, faults, run

    run.cache_dirs()
    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ["WORLD_SIZE"])))
    group = start_group(job["device"])
    try:
        with contextlib.ExitStack() as stack:
            for name in job["plants"]:
                stack.enter_context(faults.PLANTS[name]())
            if job["kind"] == "run":
                return run.run_cell(job["cell"], job["seed"], job["seconds"], job["trace"],
                                    job["device"], group=group, since=job["since"])
            recs = []
            for rec in control.readings(job["cell"], job["seeds"], job["control_seeds"],
                                        job["fault_seeds"], job["device"], job["controls"],
                                        group=group):
                if group.rank == 0:
                    recs.append(rec)
                    print(json.dumps(rec), file=sys.stderr, flush=True)
                    if job.get("out"):
                        with open(job["out"], "a") as out:
                            out.write(json.dumps(rec) + "\n")
            return recs if group.rank == 0 else None
    except BaseException:  # the launcher reports only the first failure it finds
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
