"""Join the ranks of a distributed run (``twixt_for_open_spiel_tpu/parallel/
launch.py``, ported to ``torch.distributed``).

JAX's multi-controller model runs one process a host, each driving its
host's chips.  Here a process is one rank, and a rank drives one card: run
N processes for N cards, on one host or many.  Every rank runs the same
program, joins the group through :func:`initialize_distributed`, and from
then on the env-sharded code of ``parallel/`` combines the ranks' results
with collectives (NCCL on the card, gloo on the CPU).

Usage, one process a card, through torchrun (which sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``)::

    torchrun --nproc_per_node=4 -m twixt_for_open_spiel_tpu_torch.train_arena_gate --mesh=4 ...

or with the flags of the example front door on every process::

    python -m twixt_for_open_spiel_tpu_torch.examples.selfplay_train \\
        --coordinator=10.0.0.1:8476 --num_processes=8 --process_id=$RANK
"""

from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

# Rank 0 plays the arena gates alone while the other ranks wait at the next
# collective; a board-12 gate (256 games at 64 simulations) takes minutes,
# past the 10 minutes of NCCL's default timeout.
GROUP_TIMEOUT = datetime.timedelta(hours=2)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> tuple:
    """Join (or create) the default process group; idempotent.  Returns
    ``(rank, world_size)``.

    ``coordinator_address`` is rank 0's ``host:port`` (or a full
    ``init_method`` URL such as ``file:///shared/rdzv``), with
    ``num_processes`` ranks in all and this one ``process_id``.  Without
    it, torchrun's variables are read: ``MASTER_ADDR``/``MASTER_PORT`` for
    the address, ``WORLD_SIZE`` and ``RANK``.  When neither asks for a
    group this is a no-op that returns ``(0, 1)`` and makes no group, as
    the JAX function is on one process.

    The backend follows ``device``: NCCL for ``"cuda"`` (the rank's card,
    made current here, is ``cuda:LOCAL_RANK``, or without torchrun the
    rank modulo the host's cards), gloo for ``"cpu"``.  The
    group's timeout is ``GROUP_TIMEOUT``, two hours, so that the ranks can
    wait out rank 0's gates.  A failed rendezvous raises.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"
    elif coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    else:
        return 0, 1
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    backend = _backend(device)
    if backend == "nccl":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=GROUP_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_world(coordinator_address=None, num_processes=None, process_id=None, *,
                     device="cuda") -> tuple:
    """:func:`initialize_distributed`, and when nothing asked for a group, a
    world of one on this process, so that the collectives run one rank
    wide over the device's backend.  Its only rank needs no rendezvous:
    the group's store is an in-process ``HashStore``.  Returns ``(rank,
    world_size)``."""
    rank, world = initialize_distributed(coordinator_address, num_processes, process_id,
                                         device=device)
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(), world_size=1, rank=0,
                                timeout=GROUP_TIMEOUT)
        rank, world = 0, 1
    return rank, world


def spawn_ranks(fn, world_size: int, args: tuple = (), *, timeout: float = 600.0) -> list:
    """Run ``fn(rank, world_size, rendezvous, *args)`` in ``world_size``
    fresh processes and return each rank's result, rank by rank.

    The processes start by ``spawn`` (CUDA does not survive ``fork``), so
    ``fn`` and ``args`` must pickle: ``fn`` is a module-level function.
    ``rendezvous`` is a ``file://`` URL in a temporary directory, for
    :func:`initialize_distributed` or ``init_process_group``; each rank
    runs on one CPU thread.  The results come back through files in that
    directory (``torch.save``), not through a collective.  A rank that
    raises, or a run past ``timeout`` seconds, kills every rank and
    raises here, with the failed rank's traceback."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="twixt_ranks_") as tmp:
        out = Path(tmp)
        rdzv = f"file://{out / 'rdzv'}"
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world_size, rdzv, tmp, args),
                             daemon=True) for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout
            pending = {p.sentinel: (r, p) for r, p in enumerate(procs)}
            while pending:
                left = deadline - time.monotonic()
                ready = multiprocessing.connection.wait(list(pending), timeout=max(left, 0))
                if not ready:
                    raise TimeoutError(f"{len(pending)} of {world_size} ranks still running "
                                       f"after {timeout} s")
                for sentinel in ready:
                    r, p = pending.pop(sentinel)
                    p.join()
                    if p.exitcode != 0:
                        err = out / f"rank{r}.err"
                        why = err.read_text() if err.exists() else "no traceback"
                        raise RuntimeError(f"rank {r} of {world_size} exited {p.exitcode}:\n{why}")
            return [torch.load(out / f"rank{r}.pt", map_location="cpu", weights_only=False)
                    for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def _rank_main(fn, rank, world_size, rdzv, out_dir, args) -> None:
    torch.set_num_threads(1)
    out = Path(out_dir)
    try:
        result = fn(rank, world_size, rdzv, *args)
        tmp = out / f"rank{rank}.pt.tmp"
        torch.save(result, tmp)
        os.replace(tmp, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)  # the other ranks may wait in a collective: no teardown
    if dist.is_initialized():
        dist.destroy_process_group()
