"""Devices, replicas, batch shards and the process group (port of
``tpuseg/parallel/mesh.py``).

tpuseg builds one ``jax.sharding.Mesh`` over the chips and lets XLA place a
replicated tree and a batch sharded on its "data" axis. The port is device
explicit: :func:`make_devices` is the mesh's list of devices,
:func:`replicate` puts one copy of a module on each, :func:`shard_batch`
splits a batch along its first axis. Training runs one process per GPU
(``torchrun``): :func:`init_from_env` joins the process group from the
variables torchrun sets, :func:`world` reads it; :class:`ThreadGroup` runs
ranks as threads of one process instead (a reference that needs no
process group). tpuseg's "model" axis is not ported: nothing uses it.
"""
from __future__ import annotations

import copy
import os
import threading

import torch
import torch.distributed as dist


def make_devices(n: int | str | None = None, device="cuda") -> list:
    """``n`` devices of ``device``'s type (the counterpart of
    ``make_mesh(n)``). On "cuda": ``n`` distinct GPUs, every visible one for
    None or "all"; more than are visible raises. On "cpu": ``n`` CPU
    entries (one for None or "all"), replicas of one device, as tpuseg's
    tests run a virtual 8-device mesh on one CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        visible = torch.cuda.device_count()
        if n in (None, "all"):
            n = visible
        n = int(n)
        if n > visible:
            raise ValueError(
                f"make_devices({n}) but only {visible} GPU(s) visible; "
                "refusing to silently under-provision")
        if n < 1:
            raise ValueError(f"make_devices({n}): no CUDA device")
        return [torch.device("cuda", i) for i in range(n)]
    if kind != "cpu":
        raise ValueError(f"make_devices: no devices of type {kind!r}")
    n = 1 if n in (None, "all") else int(n)
    if n < 1:
        raise ValueError(f"make_devices({n}): at least one device")
    return [torch.device("cpu")] * n


def resolve_devices(devices, device) -> list:
    """The predictors' ``devices`` (tpuseg's ``_resolve_devices``): None,
    1 or "1" one device (``device`` itself); "all" every visible device of
    ``device``'s type; an int (or its string) that many; a list of devices
    as given (entries may repeat a device)."""
    if devices in (None, 1, "1"):
        return [torch.device(device)]
    if isinstance(devices, (list, tuple)):
        return [torch.device(d) for d in devices]
    return make_devices(devices if devices == "all" else int(devices),
                        device)


def replicate(module: torch.nn.Module, devices: list) -> list:
    """One module per entry of ``devices``: ``module`` itself on its own
    device, a deep copy on each other; entries that repeat a device share
    its copy (the modules run in inference only)."""
    home = next(iter(module.parameters())).device
    copies = {}
    out = []
    for d in map(torch.device, devices):
        if d not in copies:
            copies[d] = (module if d == home
                         else copy.deepcopy(module).to(d))
        out.append(copies[d])
    return out


def _split(tree, n: int):
    """A tree (tensors in tuples, lists and dicts) -> n trees of shards."""
    if torch.is_tensor(tree):
        if tree.shape[0] % n:
            raise ValueError(f"batch of {tree.shape[0]} does not divide "
                             f"across {n} devices")
        return list(tree.chunk(n)) if tree.shape[0] else [tree] * n
    if isinstance(tree, dict):
        parts = {k: _split(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    if isinstance(tree, (tuple, list)):
        parts = [_split(v, n) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(n)]
    raise TypeError(f"shard_batch: {type(tree).__name__} is not a tensor, "
                    "tuple, list or dict")


def shard_batch(tensors, n: int) -> list:
    """``tensors`` (a tensor, or tensors in tuples, lists and dicts, each
    with the batch on its first axis) -> ``n`` such trees, shard i holding
    rows [i * B / n, (i + 1) * B / n). The batch must divide by ``n``."""
    return _split(tensors, n)


_thread = threading.local()


class ThreadGroup:
    """``n`` ranks as ``n`` threads of one process: :func:`world` and
    ``parallel/ddp.py::all_reduce`` answer for the rank of the calling
    thread inside :meth:`run`. It runs what ranks run (global normalisers,
    global draws, synchronised statistics) without ``torch.distributed``:
    the reference that two processes on one card are held to. On CUDA
    only the forward's collectives: autograd runs a CUDA backward on a
    device thread of its own, outside the group (on the CPU, on the
    calling thread)."""

    def __init__(self, n: int):
        self.n = n
        self._barrier = threading.Barrier(n)
        self._slots = [None] * n

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks, added in rank order, on every rank."""
        self._slots[_thread.rank] = t
        self._barrier.wait()
        total = self._slots[0]
        for s in self._slots[1:]:
            total = total + s.to(total.device)
        self._barrier.wait()
        return total.to(t.device)

    def run(self, fn) -> list:
        """``fn(rank)`` on ``n`` threads -> their results in rank order; the
        first error of any rank raises here (the others' waits break)."""
        results, errors = [None] * self.n, []

        def body(rank):
            _thread.group, _thread.rank = self, rank
            try:
                results[rank] = fn(rank)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                self._barrier.abort()
            finally:
                _thread.group = None

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


def thread_group() -> ThreadGroup | None:
    """The :class:`ThreadGroup` the calling thread runs in, if any."""
    return getattr(_thread, "group", None)


def world() -> tuple:
    """(rank, world size): of the calling thread's :class:`ThreadGroup`, or
    of the process group; (0, 1) without either."""
    group = thread_group()
    if group is not None:
        return _thread.rank, group.n
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_from_env(device="cuda", backend: str | None = None) -> torch.device:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) -> this rank's device:
    ``cuda:LOCAL_RANK`` on "cuda", the CPU on "cpu". The backend is NCCL on
    CUDA and gloo on the CPU unless ``backend`` names one (gloo on CUDA
    puts two ranks on one card, which NCCL refuses)."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        if var not in os.environ:
            raise RuntimeError(f"init_from_env: {var} is not set (launch "
                               "with torchrun)")
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        local = int(os.environ["LOCAL_RANK"])
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"LOCAL_RANK {local} but only {torch.cuda.device_count()} "
                "GPU(s) visible")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]))
    return dev
