"""One process of the two-process CPU runs of tests/test_torch_multihost.py.

``run`` is spawned by ``torch.multiprocessing`` (it imports no JAX, so a
worker starts in a few seconds): it joins a gloo process group through a
``file://`` store, runs its jobs in order (every process runs the same
jobs: they are collective) and writes each job's results to
``<out>/<rank>.pt``, then reports on a queue.
"""
import os
import time
import traceback

import numpy as np
import torch

#: seconds a collective may wait (the test's wall-clock limit is below it)
TIMEOUT_S = 150


def _leaves(tree) -> dict:
    """Every leaf of a state tree whole on the CPU, on process 0 (a
    collective: every process calls it)."""
    from repro_torch.checkpoint.checkpoint import leaf_paths
    out = {}
    for name, x in leaf_paths(tree):
        full = x.gather("cpu", root=0)
        if full is not None:
            out[name] = full
    return out


def _train(job: dict) -> dict:
    from repro_torch.distributed import fault
    from repro_torch.launch import train

    rank = int(os.environ["RANK"])
    guard_class = train.PreemptionGuard
    if job.get("preempt_rank") == rank:
        class Late(fault.PreemptionGuard):
            """Announces a preemption at its second check (step 1)."""

            calls = 0

            def should_save(self) -> bool:
                self.calls += 1
                return self.calls >= 2

        train.PreemptionGuard = Late
    try:
        out = train.train(train.parse_args(job["argv"]), log=lambda *a: None)
    finally:
        train.PreemptionGuard = guard_class
    mesh = out["mesh"]
    return {"losses": out["losses"], "backend": out["backend"],
            "local": list(mesh.local_positions),
            "leaves": _leaves(out["trainer"].state_tree())}


def _reference(job: dict) -> dict:
    """One ``ShardedTrainer.step`` on 1 x 4 from the reference's weights
    (``convert.transformer_from_arrays``)."""
    from repro_torch import configs, convert
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    params, tokens = torch.load(job["arrays"], weights_only=False)
    cfg = configs.get_arch(job["arch"]).make_reduced()
    mesh = make_host_mesh(1, 4)
    tr = train.ShardedTrainer(convert.transformer_from_arrays(
        cfg, params, mesh=mesh))
    loss, aux = tr.step({"tokens": torch.from_numpy(np.asarray(tokens))})
    return {"loss": float(loss), "ntokens": float(aux["ntokens"]),
            "leaves": _leaves(tr.state_tree())}


JOBS = {"train": _train, "reference": _reference}


def run(rank: int, count: int, init: str, jobs: list, out: str, q) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(count),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(count))
    torch.set_num_threads(1)
    from repro_torch.distributed import process
    try:
        process.initialize("cpu", init_method=init, timeout_s=TIMEOUT_S,
                           log=lambda *a: None)
        results = {}
        for job in jobs:
            t0 = time.perf_counter()
            results[job["name"]] = JOBS[job["kind"]](job)
            results[job["name"]]["seconds"] = time.perf_counter() - t0
        torch.save(results, os.path.join(out, f"{rank}.pt"))
        q.put((rank, None))
    except BaseException:
        q.put((rank, traceback.format_exc()))
    finally:
        process.shutdown()
