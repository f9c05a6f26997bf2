"""Process groups and batch placement for data-parallel training.

Counterpart of :mod:`asr_craft_tpu.parallel.mesh` on ``torch.distributed``.
A JAX mesh is a set of devices that one program shards arrays over, and XLA
inserts the gradient all-reduce; here each rank is one process with one
device, a :class:`Mesh` is its process group, and the trainer issues the
collectives itself (:mod:`asr_craft_tpu_torch.train.trainer`).  Batches are
split on the leading utterance axis, parameters are replicated.

- :func:`initialize_distributed` reads torchrun's environment (``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and does
  nothing for a single process.  On the card the backend is NCCL with one
  GPU a rank (``LOCAL_RANK``); gloo runs only when the caller asks for the
  CPU.  Nothing falls back from one to the other.
- :func:`make_mesh`: the process group and its size; :func:`data_shard_info`
  feeds the loader's ``(shard_id, num_shards)``; :func:`make_batch_put` puts
  a rank's batch on its device (or takes its rows of a global batch);
  :func:`replicate_tree` broadcasts rank 0's tensors;
  :func:`run_ranks` runs a function on N spawned ranks of a fresh group (a
  ``FileStore`` rendezvous: no port to choose).

Not carried over, for want of a meaning here: ``batch_shardings`` and
``replicated`` (JAX sharding annotations; a rank's batch is simply its own
tensors, placed by :func:`make_batch_put`), and ``make_mesh_2d`` (a
("data", "time") mesh whose only user in the JAX package is a test; the
port's time-sharded decode takes its own layout,
:func:`asr_craft_tpu_torch.parallel.timeshard.time_mesh`).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

# the loader batch keys that are tensors of the step (the trainer's)
BATCH_KEYS = ("feats", "labels", "lengths", "sparse_idx", "sparse_val")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel group, the default one: ``size`` ranks, this one
    ``rank``, its tensors on ``device``."""

    size: int
    rank: int
    device: torch.device


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> Optional[torch.device]:
    """Start this process's rank of a ``torch.distributed`` group and return
    its device; None, with nothing done, for a single process.

    The arguments default from torchrun's environment: ``num_processes``
    from ``WORLD_SIZE`` (1), ``process_id`` from ``RANK`` (0), the
    rendezvous ``coordinator`` (a ``tcp://host:port`` or ``file://path``
    URL) from ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``).  A coordinator
    given with ``num_processes=1`` starts a group of one rank, which still
    issues every collective.

    ``device``: ``"cuda"`` (the default) runs NCCL, each rank on GPU
    ``LOCAL_RANK`` (default: ``process_id``), and raises where that GPU is
    not visible; ``"cpu"`` runs gloo."""
    num_processes = (_env_int("WORLD_SIZE", 1) if num_processes is None
                     else num_processes)
    if num_processes <= 1 and coordinator is None:
        return None
    rank = _env_int("RANK", 0) if process_id is None else process_id
    device = torch.device(device)
    if device.type == "cuda":
        local = _env_int("LOCAL_RANK", rank)
        have = torch.cuda.device_count()
        if local >= have:
            raise RuntimeError(
                f"rank {rank} of {num_processes} needs GPU {local} for NCCL, "
                f"and {have} are visible (one GPU a rank; pass device='cpu' "
                "for gloo ranks on the CPU)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_distributed: device {device}")
    dist.init_process_group(backend, init_method=coordinator or "env://",
                            world_size=num_processes, rank=rank)
    return device


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The data-parallel mesh: the default process group, which must hold
    ``n_devices`` ranks where that is given.  Raises before
    :func:`initialize_distributed` has started a group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(call parallel.initialize_distributed first)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the world has {size} "
                         "ranks; launch one process a device")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(size, dist.get_rank(), device)


def data_shard_info() -> Dict[str, int]:
    """``{"shard_id", "num_shards"}`` for the host-sharded loader: this
    rank and the world's size (0 and 1 for a single process)."""
    if not dist.is_initialized():
        return {"shard_id": 0, "num_shards": 1}
    return {"shard_id": dist.get_rank(), "num_shards": dist.get_world_size()}


def make_batch_put(mesh: Mesh) -> Callable:
    """``put(batch, global_batch=False) -> batch``: the step's keys of a
    loader batch (numpy arrays or tensors) as tensors on the rank's device,
    the other keys as they are.  ``global_batch``: the batch is the whole
    mesh's, and the rank takes its block of ``B / size`` rows (rank ``r``
    the ``r``-th, as a JAX batch sharded over "data" is laid out); B must
    divide by the mesh's size."""
    def put(batch: Dict, global_batch: bool = False) -> Dict:
        out = {}
        for k, v in batch.items():
            if global_batch:
                n = len(v)
                if n % mesh.size:
                    raise ValueError(f"batch of {n} rows over {mesh.size} "
                                     "ranks")
                per = n // mesh.size
                v = v[mesh.rank * per:(mesh.rank + 1) * per]
            if k in BATCH_KEYS:
                v = torch.as_tensor(v)
                if mesh.device.type == "cuda" and v.device.type == "cpu":
                    v = v.contiguous().pin_memory()
                v = v.to(mesh.device, non_blocking=True)
            out[k] = v
        return out

    return put


def _tensors(tree) -> Sequence[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def replicate_tree(mesh: Mesh, tree):
    """Overwrite every tensor of ``tree`` (dicts, lists, tuples) in place
    with rank 0's, and return ``tree``: the parameters replicate on every
    rank."""
    for t in _tensors(tree):
        dist.broadcast(t.data, 0)
    return tree


def reduce_host(mesh: Mesh, values: Sequence[float], op: str = "sum"
                ) -> list:
    """``values`` (host numbers) reduced over the mesh (``op``: "sum" or
    "max"), as float64 on the rank's device: counts stay exact below
    2**53."""
    t = torch.tensor(list(values), dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM)
    return t.tolist()


def _rank_main(fn, rank, n, store, device, args, out):
    """One spawned rank of :func:`run_ranks`."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)        # N ranks share the host's cores
    initialize_distributed(f"file://{store}", n, rank, device)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn: Callable, n: int, *args, device="cuda",
              timeout: float = 600.0) -> list:
    """``[fn(*args) on rank r for r in range(n)]``: ``n`` processes
    (``spawn``), each rank ``r`` of a fresh group on ``device`` (NCCL on
    GPU ``r``, or gloo on the CPU: :func:`initialize_distributed`).  ``fn``
    and ``args`` must pickle (a module-level function); so must its
    result.  Raises when a rank fails (the others, whose collectives then
    fail, end within 10 s or are killed) or when the ranks outlast
    ``timeout`` seconds; leaves no process behind."""
    import multiprocessing
    import multiprocessing.connection
    if torch.device(device).type == "cuda" and \
            n > torch.cuda.device_count():
        raise RuntimeError(f"run_ranks: {n} NCCL ranks need {n} GPUs, and "
                           f"{torch.cuda.device_count()} are visible")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, n, os.path.join(tmp, "store"), str(device), args,
            outs[r])) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode for p in procs):
                    # a rank failed: the others end on their own within
                    # seconds (a collective fails) or are killed below
                    deadline = min(deadline, time.monotonic() + 10.0)
                if time.monotonic() > deadline:
                    if any(p.exitcode for p in procs):
                        break
                    raise TimeoutError(f"run_ranks: {n} ranks still running "
                                       f"after {timeout} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None], 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        bad = [r for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"run_ranks: ranks {bad} of {n} failed "
                               f"(exit codes "
                               f"{[procs[r].exitcode for r in bad]})")
        results = []
        for out in outs:        # written by the ranks above
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results
