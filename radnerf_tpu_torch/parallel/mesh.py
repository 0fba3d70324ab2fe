"""The ranks of a data-parallel run (twin of radnerf_tpu/parallel/mesh.py).

The reference lays one mesh axis, `ray`, over every chip of a slice. In
the port each rank is one process with one device, and the ranks form a
`torch.distributed` group: nccl between cards, gloo on the CPU (and
between ranks that share a card, which nccl refuses). `Mesh` is what a
rank knows of it: the group's size, its own index and its device (the
collectives run on the default group).

Ranks are started in one of two ways:

- `launch(n, fn, args)` runs fn on n ranks of this host: ranks 1..n-1 as
  spawned processes, rank 0 in the caller. The group meets in a file
  store in a temporary directory, so no TCP port is chosen, and rank 0
  joins it only once every spawned rank is ready to, so that a rank
  which dies first fails the launch at once. The entry points call it
  for --num_devices N > 1 (0: every local card).
- A launcher such as torchrun starts one process per card on every host
  and sets MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE and LOCAL_RANK;
  `initialize_multihost()` joins its group (--multihost).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import tempfile
import time

import torch
import torch.distributed as dist

from .. import DEFAULT_DEVICE

# how long a collective, the group's rendezvous and the join of a spawned
# rank may wait before the run fails
TIMEOUT = datetime.timedelta(minutes=30)
LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
READY_POLL = 0.05           # seconds between rank 0's looks at the others


def distributed_is_initialized() -> bool:
    """True iff this process is in a torch.distributed group."""
    return dist.is_available() and dist.is_initialized()


def backend_for(device) -> str:
    """nccl for ranks on cards, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device_count(device) -> int:
    """The cards of this host on CUDA; 1 on the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    local_rank: int | None = None,
    device=DEFAULT_DEVICE,
    backend: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> None:
    """Join a data-parallel group (a no-op where this process is in one).

    With no coordinator_address the group is a launcher's: MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE (and LOCAL_RANK, the card on this host)
    from the environment, as torchrun sets them; a RuntimeError names
    the ones missing. Otherwise `coordinator_address` is 'host:port' or
    a URL (tcp:// or file://), and num_processes and process_id are
    required; local_rank defaults to process_id. On CUDA the rank's card
    becomes the current device before the group is joined. The backend
    is nccl on CUDA and gloo on the CPU unless `backend` names one."""
    if distributed_is_initialized():
        return
    if coordinator_address is None:
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                "--multihost joins a launcher's group (torchrun sets its "
                f"environment); not set: {', '.join(missing)}")
        init_method = "env://"
        num_processes = (int(os.environ["WORLD_SIZE"])
                         if num_processes is None else num_processes)
        process_id = (int(os.environ["RANK"]) if process_id is None
                      else process_id)
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        if local_rank is None:
            local_rank = process_id
    _join(num_processes, process_id, local_rank, device, backend, timeout,
          init_method=init_method)


def _join(n: int, rank: int, local_rank: int, device, backend, timeout,
          **where) -> None:
    """Take the rank's card (on CUDA) and join the group of n ranks that
    `where` (init_method= or store=) names."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        backend or backend_for(device), world_size=n, rank=rank,
        timeout=timeout or TIMEOUT, **where)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the `ray` axis: `size` ranks, this one's index
    `rank` and its `device`."""

    size: int
    rank: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        """Rank 0, which alone writes logs, images and checkpoints."""
        return self.rank == 0

    def barrier(self) -> None:
        """Wait for every rank (a no-op at size 1)."""
        if self.size > 1:
            dist.barrier()


def single_rank_mesh(device) -> Mesh:
    return Mesh(1, 0, torch.device(device))


def make_mesh(num_devices: int = 0, device=DEFAULT_DEVICE) -> Mesh:
    """This process's Mesh over `num_devices` ranks (0: every local card,
    the reference's meaning; one on the CPU).

    In a group, the group is the mesh (num_devices must be 0 or its
    size) and a rank's card is the current device that joining set.
    Outside one, only a single rank can be built: more raise, as they
    need their processes started (`launch`, or a launcher and
    `initialize_multihost`)."""
    if distributed_is_initialized():
        size = dist.get_world_size()
        if num_devices not in (0, size):
            raise ValueError(f"num_devices {num_devices} != the group's "
                             f"{size} ranks")
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return Mesh(size, dist.get_rank(), dev)
    want = num_devices or local_device_count(device)
    if want > 1:
        raise ValueError(
            f"{want} ranks need a process each: start them with "
            "parallel.launch (the entry points do, for --num_devices), or "
            "with a launcher and --multihost")
    return single_rank_mesh(device)


def _spawned_rank(path: str, n: int, rank: int, device, timeout,
                  fn, args: tuple) -> None:
    """A spawned rank: take its card, say in the file store at `path`
    that it is ready, join the group, run fn(*args), leave the group."""
    store = dist.FileStore(path, n)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    store.set(f"ready{rank}", "1")
    _join(n, rank, rank, device, None, timeout, store=store)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _wait_for_ranks(store, procs: list, timeout) -> None:
    """Return once every spawned rank is ready to join; raise as soon as
    one has ended before that, or after `timeout`."""
    keys = [f"ready{r}" for r in range(1, len(procs) + 1)]
    t_end = time.monotonic() + timeout.total_seconds()
    while not store.check(keys):
        ended = [f"{p.name} (exit code {p.exitcode})" for p in procs
                 if p.exitcode is not None]
        if ended:
            raise RuntimeError("data-parallel ranks ended before joining "
                               f"the group: {', '.join(ended)}")
        if time.monotonic() > t_end:
            raise RuntimeError(f"data-parallel ranks not ready to join "
                               f"within {timeout}")
        time.sleep(READY_POLL)


def launch(n: int, fn, args: tuple = (), *, device=DEFAULT_DEVICE,
           rank0=None):
    """Run n ranks of this host and return rank 0's result.

    Ranks 1..n-1 are spawned processes that run fn(*args) (fn and args
    are pickled, fn by its import path) on cuda:<rank> or the CPU; rank 0
    runs rank0() (default fn(*args)) in the caller on cuda:0 or the
    CPU. The group meets in a file store in a temporary directory; rank
    0 joins it once every spawned rank is ready to, and fails at once
    where one ends first. On CUDA, n may not exceed the cards of this
    host, and the kernels are built before any rank starts. Each spawned
    rank is joined within TIMEOUT once rank 0 is done; where rank 0
    fails, they are terminated. A RuntimeError names a rank that
    failed."""
    if distributed_is_initialized():
        raise RuntimeError("launch starts a group; this process is in one")
    if torch.device(device).type == "cuda":
        if n > torch.cuda.device_count():
            raise ValueError(f"{n} ranks need {n} cards, one a rank; this "
                             f"host has {torch.cuda.device_count()}")
        from .. import kernels

        kernels.build()
    timeout = TIMEOUT
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="radnerf_ranks_") as tmp:
        path = os.path.join(tmp, "store")
        store = dist.FileStore(path, n)
        procs = [ctx.Process(target=_spawned_rank,
                             args=(path, n, r, device, timeout, fn, args),
                             name=f"rank{r}")
                 for r in range(1, n)]
        for p in procs:
            p.start()
        done = False
        try:
            _wait_for_ranks(store, procs, timeout)
            _join(n, 0, 0, device, None, timeout, store=store)
            try:
                result = rank0() if rank0 is not None else fn(*args)
            finally:
                dist.destroy_process_group()
            done = True
        finally:
            for p in procs:
                if done:
                    p.join(timeout.total_seconds())
                if p.is_alive():
                    p.terminate()
                    p.join()
    failed = [f"{p.name} (exit code {p.exitcode})" for p in procs
              if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"data-parallel ranks failed: {', '.join(failed)}")
    return result
