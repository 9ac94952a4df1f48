"""Ranks: one process per device, joined in one ``torch.distributed`` group
(the port's counterpart of the JAX package's implicit multi-device
runtime, where one controller drives every device).

  - ``Ranks(world_size, device=...)`` spawns one worker per rank and keeps
    it for several calls: ``run(fn, *args)`` calls ``fn(*args)`` on every
    rank and returns the per-rank results. ``launch`` is one call of it.
    ``fn`` must be importable by module name (a function of the port): the
    workers are spawned, not forked.
  - ``join(device)`` joins a group a launcher started (``torchrun`` sets
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``).

Each rank is pinned to ``cuda:LOCAL_RANK`` (``torch.cuda.set_device``) and
talks NCCL, or gloo on the CPU. Spawned ranks meet through a ``FileStore``
in a fresh temporary directory (no fixed port: several groups may run side
by side). Every group has an explicit timeout, so a collective that one
rank never joins fails on the others within that time instead of hanging.

Nothing falls back: an NCCL failure raises, and more ranks than CUDA
devices raise. The one way to put two ranks on one card is
``Ranks(2, backend="gloo", devices=[cuda:0, cuda:0])`` through this API
(no CLI flag reaches it): it checks the sharded arithmetic on a one-card
machine, and says nothing about scaling. gloo takes every collective used
here on CUDA tensors as they are (all-gather into one tensor, all-reduce,
broadcast: ``chip_smoke.py``'s ``[multigpu]`` phase probes each), so
nothing is staged through host memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0
CALL_TIMEOUT_S = 900.0

_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@dataclasses.dataclass(frozen=True)
class RankInfo:
    rank: int
    world_size: int
    device: torch.device
    backend: str


# this process's rank, set once when it joins (process-wide, like the
# default process group it describes)
_joined: Optional[RankInfo] = None


def current() -> Optional[RankInfo]:
    """This process's rank, or None outside a group."""
    return _joined


def _bind(rank: int, world: int, backend: str, device: torch.device, timeout_s: float,
          **init) -> RankInfo:
    global _joined
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **init)
    _joined = RankInfo(rank, world, device, backend)
    return _joined


def _cuda_devices(n: int) -> List[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{n} rank(s) on CUDA requested but no CUDA device is available "
                           "(pass --device cpu to run gloo ranks on the CPU)")
    have = torch.cuda.device_count()
    if n > have:
        raise RuntimeError(f"{n} ranks need {n} CUDA devices, this host has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def rank_devices(world_size: int, device: str = "cuda", backend: Optional[str] = None,
                 devices: Optional[Sequence] = None) -> tuple:
    """(devices, backend) for ``world_size`` ranks: one CUDA device each
    over NCCL, or the CPU over gloo; explicit ``devices`` may repeat a
    card only under gloo."""
    if devices is None:
        devices = (_cuda_devices(world_size) if torch.device(device).type == "cuda"
                   else [torch.device("cpu")] * world_size)
    devices = [torch.device(d) for d in devices]
    if len(devices) != world_size:
        raise ValueError(f"{world_size} ranks, {len(devices)} devices given")
    backend = backend or ("nccl" if devices[0].type == "cuda" else "gloo")
    if backend == "nccl" and (any(d.type != "cuda" for d in devices)
                              or len(set(devices)) != len(devices)):
        raise ValueError(f"NCCL needs one CUDA device per rank, got {devices}; two ranks "
                         "share a card only with backend='gloo'")
    return devices, backend


def _worker(rank, world, backend, devices, store_path, timeout_s, threads, inbox, outbox):
    try:
        if threads:
            torch.set_num_threads(threads)
        _bind(rank, world, backend, devices[rank], timeout_s,
              store=dist.FileStore(store_path, world))
    except Exception:
        outbox.put((rank, False, traceback.format_exc()))
        return
    outbox.put((rank, True, None))
    try:
        while True:
            task = inbox.get()
            if task is None:
                return
            fn, args, kwargs = task
            try:
                outbox.put((rank, True, fn(*args, **kwargs)))
            except Exception:
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Ranks:
    """``world_size`` spawned ranks in one process group, serving calls.

    ``device``: ``"cuda"`` (one card per rank, NCCL) or ``"cpu"`` (gloo);
    ``devices``/``backend`` override both (see the module docstring).
    ``timeout_s`` bounds every collective; ``threads`` sets each rank's
    torch intra-op threads. Close it (or use ``with``) to stop the
    workers."""

    def __init__(self, world_size: int, *, device: str = "cuda", backend: Optional[str] = None,
                 devices: Optional[Sequence] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: Optional[int] = None):
        self.devices, self.backend = rank_devices(world_size, device, backend, devices)
        self.world_size = world_size
        self.timeout_s = timeout_s
        self._tmp = tempfile.mkdtemp(prefix="lt_ranks_")
        ctx = multiprocessing.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(world_size)]
        self._procs = [
            ctx.Process(target=_worker, daemon=True, name=f"rank{r}",
                        args=(r, world_size, self.backend, self.devices,
                              os.path.join(self._tmp, "store"), timeout_s, threads,
                              self._inboxes[r], self._outbox))
            for r in range(world_size)]
        for p in self._procs:
            p.start()
        try:
            self._collect(timeout_s + 60.0)
        except BaseException:
            self.close()
            raise

    def _collect(self, timeout_s: float) -> list:
        """Every rank's result. After a rank fails, the others get the
        group's timeout (a collective the failed rank left may never
        return: gloo on CUDA tensors waits on the card) and are then
        stopped; the first failure is raised."""
        results: List[Any] = [None] * self.world_size
        errors = {}
        pending = set(range(self.world_size))
        deadline = time.monotonic() + timeout_s
        while pending:
            try:
                rank, ok, value = self._outbox.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r in pending if not self._procs[r].is_alive()]
                if dead:
                    errors.update({r: f"exited (code {self._procs[r].exitcode})" for r in dead})
                    pending -= set(dead)
                elif time.monotonic() > deadline:
                    if not errors:
                        self.close()
                        raise TimeoutError(f"rank(s) {sorted(pending)} gave no result within "
                                           f"{timeout_s:.0f} s")
                    break
                continue
            pending.discard(rank)
            if ok:
                results[rank] = value
            else:
                errors[rank] = value
                deadline = min(deadline, time.monotonic() + self.timeout_s + 15.0)
        if errors:
            if pending:
                self.close()
            first = min(errors)
            raise RuntimeError(f"rank {first} of {self.world_size} failed"
                               + (f" (rank(s) {sorted(pending)} stopped)" if pending else "")
                               + f":\n{errors[first]}")
        return results

    def run(self, fn: Callable, *args, timeout_s: float = CALL_TIMEOUT_S, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank; the per-rank results in
        rank order. A rank's exception is raised here with its traceback."""
        for box in self._inboxes:
            box.put((fn, args, kwargs))
        return self._collect(timeout_s)

    def close(self) -> None:
        for box, p in zip(self._inboxes, self._procs):
            if p.is_alive():
                box.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "Ranks":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def launch(fn: Callable, world_size: int, *, args: Sequence = (), kwargs: Optional[dict] = None,
           call_timeout_s: float = CALL_TIMEOUT_S, **rank_kw) -> list:
    """Spawn ``world_size`` ranks (``Ranks``' keywords), run ``fn`` once on
    each, stop them; the per-rank results."""
    with Ranks(world_size, **rank_kw) as ranks:
        return ranks.run(fn, *args, timeout_s=call_timeout_s, **(kwargs or {}))


def launched() -> bool:
    """True when a launcher set this process's rank in the environment."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join(device: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> RankInfo:
    """Join the group a launcher started (``env://`` rendezvous), pinned
    to ``cuda:LOCAL_RANK`` (NCCL) or the CPU (gloo)."""
    if _joined is not None:
        return _joined
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        dev = _cuda_devices(local + 1)[local]
        return _bind(rank, world, "nccl", dev, timeout_s, init_method="env://")
    return _bind(rank, world, "gloo", torch.device("cpu"), timeout_s, init_method="env://")


# -- collectives -------------------------------------------------------------

# when a list: every collective below appends (op, bytes it sends, host
# seconds), synchronizing the device around it (measurement only)
collective_log: Optional[list] = None


def _logged(op: str, t: torch.Tensor, fn: Callable[[], Any]) -> Any:
    if collective_log is None:
        return fn()
    sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    collective_log.append((op, t.numel() * t.element_size(), time.perf_counter() - t0))
    return out


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """A 2-byte float as int16 (a gather is a copy; not every backend
    takes bf16)."""
    return t.view(torch.int16) if t.dtype in (torch.bfloat16, torch.float16) else t


def all_gather(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Concatenate ``t`` of every rank of ``group`` (``size`` ranks) along
    dim 0, in group rank order."""
    t = t.contiguous()
    if size == 1:
        return t
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _logged("all_gather", t, lambda: _all_gather_single(_as_bits(out), _as_bits(t), group=group))
    return out


def all_reduce_(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    if size > 1:
        _logged("all_reduce", t, lambda: dist.all_reduce(t, group=group))
    return t


def broadcast_(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``t`` of the group's first rank, in place on every rank of it."""
    if size > 1:
        src = dist.get_global_rank(group, 0) if group is not None else 0
        _logged("broadcast", t, lambda: dist.broadcast(t, src=src, group=group))
    return t
