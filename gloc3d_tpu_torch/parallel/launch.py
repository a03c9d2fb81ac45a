"""Start a process group of N ranks from one process: the port's
counterpart of JAX's one process driving an N-device mesh.

``spawn(fn, n, device)`` starts n fresh processes (``torch.multiprocessing``,
the spawn method), joins them into one group over
``tcp://127.0.0.1:<free port>`` and runs ``fn(rank, n, rank_device,
*args)`` in each; it returns when every rank has returned and raises when
one fails. The backend and each rank's device follow ``device``:

- a card, with at least n cards: NCCL, rank r on ``cuda:r``;
- a card, with fewer: gloo, the ranks sharing the cards round robin (the
  one-card machine at n = 2);
- the CPU: gloo on CPU tensors.

A rank imports torch, numpy and the port only, and takes the launching
process's TF32 settings (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``): a fresh process would otherwise
run cuDNN's fp32 convolutions in TF32 where its parent does not. CPU ranks
share the launching process's intra-op threads (``torch.get_num_threads()``
over n, at least one each) rather than each spin on every core.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def max_ranks() -> int:
    """The most ranks one command may start: one per CPU core this process
    may run on (each rank is a process with its own host work)."""
    return len(os.sched_getaffinity(0))


def placement(device, n: int) -> Tuple[str, List[str]]:
    """(backend, each rank's device) for n ranks on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device is available")
        if n <= cards:
            return "nccl", [f"cuda:{r}" for r in range(n)]
        return "gloo", [f"cuda:{r % cards}" for r in range(n)]
    if device.type != "cpu":
        raise ValueError(f"cannot place ranks on {device}")
    return "gloo", ["cpu"] * n


def check_ranks(n: int) -> None:
    """Refuse a rank count below 1 or above ``max_ranks()``."""
    if not 1 <= n <= max_ranks():
        raise ValueError(f"{n} ranks requested; between 1 and {max_ranks()} "
                         f"may run here (one per CPU core of this process)")


def _rank_main(rank: int, n: int, port: int, backend: str,
               devices: Sequence[str], tf32: Tuple[bool, bool],
               threads: int, fn: Callable, args: tuple) -> None:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        fn(rank, n, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device, args: tuple = ()) -> None:
    """Run ``fn(rank, n, device_of_rank, *args)`` on n spawned ranks of one
    group (see the module docstring); ``fn`` must be importable by name."""
    check_ranks(n)
    backend, devices = placement(device, n)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    threads = max(1, torch.get_num_threads() // n)
    torch.multiprocessing.start_processes(
        _rank_main, args=(n, free_port(), backend, devices, tf32, threads,
                          fn, args),
        nprocs=n, join=True, start_method="spawn")
