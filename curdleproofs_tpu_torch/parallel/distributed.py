"""Multi-process execution on torch.distributed.

Counterpart of the JAX package's `parallel/distributed.py`. There one process
drives every device of a host and `jax.distributed` stretches that program
over hosts. Here every device has a process of its own, and the processes
join one torch.distributed process group; `parallel.mesh` lays the mesh over
that world. Each process runs the same program on the same inputs and keeps
its own block of the points (parallel/msm.py).

Usage, one process a GPU:

    torchrun --nproc_per_node=N program.py          # initialize() reads the
                                                    # launcher's environment
or by hand, in each of N processes:

    from curdleproofs_tpu_torch.parallel import distributed, make_mesh, msm_sharded_stream
    distributed.initialize("host0:29500", num_processes=N, process_id=i)
    mesh = make_mesh()                               # the world, one axis
    result = msm_sharded_stream(bases, scalars, mesh=mesh)

The backend is NCCL for a CUDA device and gloo for the CPU. NCCL refuses two
ranks on one GPU ("Duplicate GPU detected"), so ranks that share a card join
over gloo (`backend="gloo"`), which carries the small window-sum tensors
through host memory. `spawn` starts such a world on one host, as the tests
and `chip_smoke.py` do.
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from curdleproofs_tpu_torch.utils.device import DeviceArg, resolve_device


def local_device(device: DeviceArg = None) -> torch.device:
    """This process's device: `device` where given, else the GPU the launcher
    assigned (`cuda:LOCAL_RANK`, 0 outside a launcher). Raises without a
    card unless the caller names the CPU."""
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceArg = None,
) -> None:
    """Join this process to the process group (no-op when it has joined
    already, or when it runs alone and no address is given).

    coordinator_address: "host:port" (as `jax.distributed.initialize` takes
    it) or any torch.distributed init method URL ("tcp://...", "file://...",
    "env://"); under torchrun it defaults to the launcher's environment, as
    do num_processes (WORLD_SIZE) and process_id (RANK). backend: "nccl"
    for a CUDA device, "gloo" for the CPU, unless named."""
    if dist.is_initialized():
        return
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", "0")) if process_id is None else process_id
        coordinator_address = coordinator_address or "env://"
    if num_processes in (None, 1) and coordinator_address is None:
        return  # one process: nothing to join
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize: give the coordinator address, the number of processes and this process's id")
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id)


def shutdown() -> None:
    """Leave the process group (no-op when this process never joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank_main(rank: int, fn, world: int, backend: str, device: str, tmp: str, args) -> None:
    """One rank of `spawn`: join the world by its file store, run fn, leave
    the world, and write fn's result where the parent reads it."""
    # each rank's host work is one thread's: the ranks share the host's cores
    torch.set_num_threads(1)
    initialize(f"file://{os.path.join(tmp, 'store')}", world, rank, backend=backend, device=device)
    try:
        out = fn(*args)
    finally:
        shutdown()
    with open(os.path.join(tmp, f"rank{rank}.out"), "wb") as fh:
        pickle.dump(out, fh)


def spawn(
    fn: Callable[..., Any],
    nprocs: int,
    args: Sequence[Any] = (),
    backend: str = "gloo",
    device: str = "cpu",
    timeout: float = 600.0,
) -> List[Any]:
    """Run fn(*args) in `nprocs` fresh processes joined in one process group
    (a file-store rendezvous in a temporary directory, so concurrent worlds
    never meet on a port) and return each rank's result, in rank order.
    fn must be importable by name (a module-level function) and its result
    picklable. Every rank runs on `device`. When a rank fails,
    torch.multiprocessing stops the others and raises
    ProcessRaisedException with its traceback; when the world has not
    finished within `timeout` seconds, every rank is killed and TimeoutError
    raised."""
    with tempfile.TemporaryDirectory(prefix="curdle-world-") as tmp:
        ctx = mp.start_processes(
            _rank_main, (fn, nprocs, backend, str(device), tmp, tuple(args)), nprocs,
            join=False, daemon=True,
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic()), grace_period=5):
                if time.monotonic() >= deadline:
                    hung = [r for r, p in enumerate(ctx.processes) if p.is_alive()]
                    raise TimeoutError(f"spawn: ranks {hung} of {nprocs} still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.out"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
