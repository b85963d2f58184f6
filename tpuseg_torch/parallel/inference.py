"""Batch-sharded inference over several devices (port of
``tpuseg/parallel/inference.py``).

tpuseg jits ``fn(params, *batch)`` with the params replicated and the batch
sharded over the mesh's "data" axis; each chip runs the program (and its
Pallas kernels) on its shard. Here one replica of the module sits on each
device and one thread per replica issues its shard: the forwards are bound
by the host's issue of launches, and CUDA calls release the interpreter
lock, so the replicas' launches overlap. tpuseg's ``use_shard_map`` has no
counterpart: a CUDA kernel runs on its own shard whatever wraps it.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from tpuseg_torch.parallel.mesh import replicate, shard_batch


def _to(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


def _concat(parts: list, device):
    """Per-shard output trees -> one tree, the shards' rows in order, on
    ``device``."""
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts], device) for k in first}
    return type(first)(_concat([p[i] for p in parts], device)
                       for i in range(len(first)))


class ShardedInference:
    """``fn(module, *batch_args) -> tree`` over a batch split across
    ``devices``: one replica of ``module`` per entry (entries may repeat a
    device: its replicas share one copy), each called under
    ``torch.inference_mode`` on its shard, from a thread of its own. The
    first ``n_batch_args`` arguments carry the batch on their first axis
    (tensors, or tensors in tuples, lists and dicts), which must divide
    across the devices; the outputs come back concatenated in batch order
    on the first device."""

    def __init__(self, fn, module: torch.nn.Module, devices: list,
                 n_batch_args: int = 1):
        if not devices:
            raise ValueError("ShardedInference needs at least one device")
        self.fn = fn
        self.devices = [torch.device(d) for d in devices]
        self.data_size = len(self.devices)
        self.replicas = replicate(module, self.devices)
        self.n_batch_args = n_batch_args

    def _run_shard(self, i: int, args: tuple):
        dev = self.devices[i]
        with torch.inference_mode():
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return self.fn(self.replicas[i], *_to(args, dev))
            return self.fn(self.replicas[i], *args)

    def __call__(self, *batch_args):
        if len(batch_args) != self.n_batch_args:
            raise TypeError(f"expected {self.n_batch_args} batch argument(s),"
                            f" got {len(batch_args)}")
        shards = shard_batch(tuple(batch_args), self.data_size)
        if self.data_size == 1:
            outs = [self._run_shard(0, shards[0])]
        else:
            with ThreadPoolExecutor(self.data_size) as pool:
                futures = [pool.submit(self._run_shard, i, s)
                           for i, s in enumerate(shards)]
                outs = [f.result() for f in futures]
        return _concat(outs, self.devices[0])
