"""Run a function on every rank of a `torch.distributed` world.

    run_ranks(fn, world_size, device, *args, timeout_s=600.0)

spawns `world_size` processes on this host (the spawn start method: the
caller may hold threads, a CUDA context or JAX, none of which survives a
fork), which meet through a `FileStore` in a temporary directory, so that
concurrent worlds on one host never contend for a port. Each rank sets its
device (card rank % cards; on the CPU it takes its share of the caller's
torch threads), joins the world on the backend that `mesh.backend_for`
picks from the layout, calls fn(*args) and sends back its result (pickled).
The results come back in rank order. When a rank raises, dies, or the
timeout passes, the other ranks are ended and `run_ranks` raises with the
failing rank's traceback: no failure hangs the caller.

fn and its arguments are pickled, so fn is a module-level function of this
package: the children import the package, not the caller's module. The
caller's process builds the CUDA library and the LC engine before it
spawns, so that no two ranks build into `_build/` at once.

Under `torchrun` (RANK set), the caller is already one rank of a world,
possibly of several hosts: run_ranks sets card LOCAL_RANK % cards, picks
the backend from LOCAL_WORLD_SIZE (the ranks on this host) against this
host's cards, joins the world through `env://` (its size is WORLD_SIZE,
which must equal world_size), calls fn(*args) in this process, and returns
every rank's result, gathered as objects. A caller that touches the card
before run_ranks calls `use_local_card` first.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import backend_for


def torchrun() -> bool:
    """Whether this process is a rank that torchrun started."""
    return "RANK" in os.environ


def world_backend(device, world_size: int) -> str:
    """The backend of a world of world_size ranks on `device`: all on this
    host, or under torchrun LOCAL_WORLD_SIZE of them."""
    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    local = int(os.environ["LOCAL_WORLD_SIZE"]) if torchrun() else world_size
    return backend_for(dev.type, local, cards)


def use_local_card(device) -> None:
    """Under torchrun, on CUDA, make card LOCAL_RANK % cards this process's
    current device (run_ranks does it too; call it before any CUDA work
    that comes first). Elsewhere nothing."""
    if torchrun() and torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())


def prepare(device) -> None:
    """Build what the ranks load, once, in this process: the LC engine,
    and on CUDA the kernels' library."""
    from ..relations import native

    native.build()
    if torch.device(device).type == "cuda":
        from .. import _native

        _native.build()


def run_each(*calls) -> list:
    """calls (fn, args), each fn(*args) in turn on this rank -> their
    results: several steps in one world, for one spawn (a spawn and the
    world's set-up cost seconds; the CPU tests run several checks in a
    world with it)."""
    return [fn(*args) for fn, args in calls]


def _join(rank: int, local_rank: int, world_size: int, device: str, backend: str, init: dict,
          timeout_s: float) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **init)


def _rank_main(fn, rank: int, world_size: int, device: str, backend: str, store_path: str,
               args: tuple, timeout_s: float, threads: int, results) -> None:
    # the ranks of one launch share this host: the backends' sockets stay on loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if torch.device(device).type == "cpu":  # the ranks split the caller's threads
        torch.set_num_threads(max(1, threads // world_size))
    try:
        store = dist.FileStore(store_path, world_size)
        _join(rank, rank, world_size, device, backend, {"store": store}, timeout_s)
        msg = (rank, True, pickle.dumps(fn(*args)))
    except Exception:  # reported to the launcher, which raises it
        msg = (rank, False, traceback.format_exc())
    results.put(msg)
    if msg[1] and dist.is_initialized():
        dist.destroy_process_group()


def _collect(procs, results, deadline: float) -> list:
    out = {}
    while len(out) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.2)
        except queue.Empty:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(len(procs))) - set(out))} did not finish in time"
                ) from None
            dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
            if dead and results.empty():
                raise RuntimeError(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                                   " before it reported")
            continue
        if not ok:  # the other ranks may wait on this one forever
            raise RuntimeError(f"rank {rank} of {len(procs)} raised:\n{payload}")
        out[rank] = pickle.loads(payload)
    return [out[r] for r in range(len(procs))]


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(fn, world_size: int, device, *args, timeout_s: float = 600.0) -> list:
    """fn(*args) on every rank of a new world of world_size ranks on
    `device` ("cpu" or "cuda") -> the results in rank order."""
    backend = world_backend(device, world_size)
    if torchrun():
        if int(os.environ["WORLD_SIZE"]) != world_size:
            raise ValueError(f"WORLD_SIZE is {os.environ['WORLD_SIZE']}, not {world_size}")
        _join(int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"]), world_size, str(device),
              backend, {"init_method": "env://"}, timeout_s)
        try:
            result = fn(*args)
            out = [None] * world_size
            dist.all_gather_object(out, result)
            return out
        finally:
            dist.destroy_process_group()
    prepare(device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="snark_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(fn, r, world_size, str(device), backend, store, args, timeout_s,
                              torch.get_num_threads(), results))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        try:
            return _collect(procs, results, time.monotonic() + timeout_s)
        finally:
            _stop(procs)
