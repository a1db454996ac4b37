"""Process groups, rank-0 gating and the launcher of data-parallel ranks.

Port of ``moco_flow_tpu/parallel/multihost.py`` on ``torch.distributed``.
One process is one rank and drives one device. A run gets its ranks in one
of three ways:

- :func:`launch` spawns one process a device of a list (``train`` / ``test``
  with ``--num_devices``, or one rank per visible card);
- ``torchrun`` starts the processes and :func:`maybe_init_distributed`
  reads its environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``);
- every host runs the same command with ``--coordinator_address``,
  ``--num_processes`` and ``--process_id`` (JAX's multi-host flags).

The backend is fixed from the ranks' devices before any work, and nothing
switches it after a failure: NCCL when every rank has a card of its own,
gloo when the ranks run on the CPU or share a card (NCCL refuses two ranks
on one device). Without a process group the run is world 1:
:func:`process_index` is 0, :func:`process_count` 1 and :func:`is_main`
True, and no collective runs. Side effects (checkpoints, logs, images,
meshes) are rank 0's, as the JAX package's are process 0's.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=30)


def backend_for(devices) -> str:
    """``nccl`` when every rank's device is a distinct card, ``gloo`` when
    every rank is on the CPU or the ranks share a card; a mix raises."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on {sorted(kinds)}: all ranks must be on "
                         "the CPU or all on CUDA cards")
    idx = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(idx)) == len(idx) else "gloo"


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def maybe_init_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           require: bool = False) -> bool:
    """Join the process group of a multi-process run if one is configured.

    Explicit arguments win over torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend is
    :func:`backend_for` of this host's ranks: ``LOCAL_WORLD_SIZE`` ranks on
    the visible cards, or the CPU where there is none. With nothing
    configured returns False (world 1), unless ``require`` (``--dist``),
    which raises rather than letting N processes train N independent jobs.
    Returns True once the group exists."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        if require:
            raise RuntimeError(
                "--dist was requested but no process group is configured: "
                "run under torchrun or pass --coordinator_address / "
                "--num_processes / --process_id")
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise RuntimeError(
            "a multi-process run needs the coordinator's host:port, the "
            "number of processes and this process's rank (got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r})")
    backend = backend_for(local_devices(
        "cuda" if torch.cuda.is_available() else "cpu"))
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id), timeout=TIMEOUT)
    return True


def local_devices(kind: str) -> list:
    """The devices of this host's ranks under torchrun
    (``LOCAL_WORLD_SIZE`` of them, rank ``i`` on card ``i`` modulo the
    visible cards), or one device for a lone process."""
    n = _env_int("LOCAL_WORLD_SIZE") or 1
    if kind == "cpu":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device here (pass --device cpu for the "
                           "plain versions)")
    return [torch.device("cuda", i % cards) for i in range(n)]


def rank_device(kind: str) -> torch.device:
    """This process's device in a process group: its ``LOCAL_RANK``'s entry
    of :func:`local_devices`."""
    return local_devices(kind)[(_env_int("LOCAL_RANK") or 0)
                               % len(local_devices(kind))]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """True on the rank that owns the run's side effects (rank 0)."""
    return process_index() == 0


def barrier():
    """Wait for every rank; nothing at world 1."""
    if process_count() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (itself at world 1)."""
    if process_count() <= 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, devices, backend, port, args, results):
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:   # CPU ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads()
                                      // len(devices)))
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{port}",
                                world_size=len(devices), rank=rank,
                                timeout=TIMEOUT)
        try:
            out = fn(rank, len(devices), dev, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, devices, *args) -> list:
    """Run ``fn(rank, world, device, *args)`` on one rank a device of
    ``devices`` and return each rank's result, in rank order.

    One device runs ``fn`` in this process, with no process group. Several
    spawn one process each (CUDA cannot be forked), in a process group on
    localhost whose backend :func:`backend_for` fixes before anything runs;
    the CUDA kernels are built here first, so the ranks only load them.
    ``fn``, ``args`` and the results must pickle. A rank that raises makes
    the launch raise with its traceback, after every rank has stopped."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("launch needs at least one device")
    if len(devices) == 1:
        return [fn(0, 1, devices[0], *args)]
    backend = backend_for(devices)
    if any(d.type == "cuda" for d in devices):
        from ..ops._build import build
        build()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, devices, backend, port, args, results))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    got, failed = {}, []
    try:
        while len(got) < len(procs) and not failed:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    failed.append((dead[0][0], "exited with code "
                                   f"{dead[0][1]} before its result"))
                continue
            if ok:
                got[rank] = out
            else:
                failed.append((rank, out))
    finally:
        if failed:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
    if failed:
        rank, tb = failed[0]
        raise RuntimeError(f"rank {rank} of {len(devices)} failed:\n{tb}")
    return [got[r] for r in range(len(devices))]
