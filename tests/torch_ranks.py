"""Gloo ranks for the port's data-parallel tests, as subprocesses of the
test on a free localhost port: :func:`spawn` starts ``world`` processes of
``python -m tests.torch_ranks``, each of which joins the group, runs one
job of :data:`JOBS` on the inputs the test saved and saves what it got.
Nothing here imports jax (a rank starts in a few seconds)."""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` gloo ranks running ``job`` (see :func:`start`)."""

    def __init__(self, job: str, world: int, tmp: Path, inputs: dict):
        self.job, self.tmp = job, Path(tmp)
        torch.save(inputs, self.tmp / f"{job}.in.pt")
        port = free_port()
        self.procs = []
        for rank in range(world):
            env = {**os.environ, "RANK": str(rank),
                   "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "OMP_NUM_THREADS": "2",
                   "PYTHONPATH": os.pathsep.join(
                       [str(ROOT), os.environ.get("PYTHONPATH", "")])}
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_ranks", job,
                 str(self.tmp)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(self, timeout: float = 120.0) -> list:
        """Each rank's output, in rank order. Each process is waited for
        with ``timeout``; a rank that fails or times out raises with its
        output, and every rank is killed."""
        try:
            logs = [p.communicate(timeout=timeout)[0] for p in self.procs]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {rank} of {self.job} exited "
                                   f"{p.returncode}:\n{log[-4000:]}")
        return [torch.load(self.tmp / f"{self.job}.{r}.pt",
                           weights_only=False)
                for r in range(len(self.procs))]


def start(job: str, world: int, tmp: Path, inputs: dict) -> Ranks:
    """Start ``job`` on ``world`` gloo ranks; ``.wait()`` for their
    outputs."""
    return Ranks(job, world, tmp, inputs)


def spawn(job: str, world: int, tmp: Path, inputs: dict,
          timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` gloo ranks -> each rank's output."""
    return start(job, world, tmp, inputs).wait(timeout)


# --- the jobs: job(inputs, rank, world) -> output ------------------------


def _rows(t, rank: int, world: int):
    b = t.shape[0] // world
    return t[rank * b:(rank + 1) * b]


def sync_bn_job(inp: dict, rank: int, world: int) -> dict:
    """A SyncBatchNorm2d on this rank's rows of x: y, d x, d weight, d bias
    (this rank's own part) and the running statistics."""
    from tpuseg_torch.parallel.sync_bn import SyncBatchNorm2d

    bn = SyncBatchNorm2d(inp["x"].shape[1]).double().train()
    bn.load_state_dict(inp["state"])
    x = _rows(inp["x"], rank, world).clone().requires_grad_()
    y = bn(x)
    (y * _rows(inp["g"], rank, world)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var,
            "num_batches_tracked": bn.num_batches_tracked}


def yolact_step(inp: dict, rank: int = 0, world: int = 1) -> dict:
    """One YOLACT training forward and backward of ``train_step``'s (SGD
    at lr 0, so the parameters stay) on this rank's rows of the batch and
    draws, train-mode BatchNorm (synchronised on more than one rank),
    under DDP when a group is up -> the losses (the global batch's), every
    gradient (DDP's mean) and the running statistics."""
    import torch.distributed as dist

    from tpuseg_torch.engine import trainer as TT
    from tpuseg_torch.engine import yolact_train_loop as TL
    from tpuseg_torch.models import yolact as Y
    from tpuseg_torch.models import yolact_loss as YL
    from tpuseg_torch.parallel import ddp
    from tpuseg_torch.parallel.sync_bn import convert_sync_bn

    cfg, dtype = inp["cfg"], inp["dtype"]
    model = Y.build_model(cfg)
    model.load_state_dict(inp["state"])
    model = model.to(dtype).train()
    if world > 1:
        convert_sync_bn(model)
    bound = None
    if dist.is_initialized():
        bound = ddp.wrap(TT.Bound(model, TL.train_losses), "cpu",
                         find_unused_parameters=model.maskiou_net is not None)
    targets = {k: _rows(v, rank, world) for k, v in inp["targets"].items()}
    losses = TL.train_step(
        model, TT.make_yolact_optimizer(model), 0.0,
        _rows(inp["images"], rank, world), targets,
        torch.from_numpy(Y.make_priors_np(cfg)).to(dtype),
        _rows(inp["draws"], rank, world), YL.YolactLossConfig(), None, bound)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "buffers": {n: b for n, b in model.named_buffers()}}


def maskrcnn_step(inp: dict, rank: int = 0, world: int = 1) -> dict:
    """One Mask R-CNN ``forward_train_losses`` and backward on this rank's
    rows of the batch and of the given draws, under DDP when a group is up
    -> the losses (the global batch's) and every gradient (DDP's mean)."""
    import torch.distributed as dist

    from tpuseg_torch.engine import trainer as TT
    from tpuseg_torch.models import maskrcnn as M
    from tpuseg_torch.parallel import ddp

    model = M.build_model(inp["cfg"])
    model.load_state_dict(inp["state"])
    model = model.double().train()
    step = TT.Bound(model, M.forward_train_losses)
    if dist.is_initialized():
        step = ddp.wrap(step, "cpu")
    b = inp["images"].shape[0] // world
    draws = {k: v[rank * b:(rank + 1) * b] for k, v in inp["draws"].items()}
    targets = {k: _rows(v, rank, world) for k, v in inp["targets"].items()}
    losses = step(_rows(inp["images"], rank, world),
                  _rows(inp["image_hw"], rank, world), targets, draws=draws,
                  loss_cfg=inp["loss_cfg"])
    losses["total"].backward()
    losses = ddp.mean_over_ranks({k: v.detach() for k, v in losses.items()})
    return {"losses": {k: float(v) for k, v in losses.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()
                      if p.requires_grad}}


def collectives_job(inp: dict, rank: int, world: int) -> dict:
    """``parallel/ddp.py``'s helpers on rank-specific values."""
    from tpuseg_torch.parallel import ddp

    values = inp["values"][rank]
    gen = torch.Generator().manual_seed(5)
    return {
        "kth": ddp.global_kth_largest(values, inp["k"]),
        "kth_big": ddp.global_kth_largest(values, 100),
        "rows": ddp.global_rows(
            lambda n: torch.rand((n, 3), generator=gen), 2),
        "denominator": ddp.denominator(torch.tensor(rank * 3), 1),
        "mean": ddp.mean_over_ranks({"a": torch.tensor(float(rank + 1)),
                                     "b": torch.tensor(2.0 * rank)}),
    }


class TinyNet(torch.nn.Module):
    """conv, BatchNorm, ReLU, conv: the bf16 DDP step's model."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.bn = torch.nn.BatchNorm2d(8)
        self.conv2 = torch.nn.Conv2d(8, 4, 3, padding=1)

    def forward(self, x):
        return self.conv2(torch.relu(self.bn(self.conv1(x))))


def tiny_loss(model, x, t):
    """The mean squared error over the global batch."""
    from tpuseg_torch.parallel import ddp

    return {"total": ((model(x).float() - t) ** 2).sum()
            / (ddp.denominator(t.shape[0]) * t[0].numel())}


def bf16_ddp_job(inp: dict, rank: int = 0, world: int = 1) -> dict:
    """Two SGD steps of :class:`TinyNet` in bf16 (``call_bound`` on
    ``cast_floats``), train-mode BatchNorm synchronised, under DDP when a
    group is up -> the f32 masters' gradients of each step, their dtypes
    and the running statistics."""
    import torch.distributed as dist

    from tpuseg_torch.engine import trainer as TT
    from tpuseg_torch.parallel import ddp
    from tpuseg_torch.parallel.sync_bn import convert_sync_bn

    model = TinyNet()
    model.load_state_dict(inp["state"])
    model.train()
    if world > 1:
        convert_sync_bn(model)
    step = TT.Bound(model, tiny_loss)
    if dist.is_initialized():
        step = ddp.wrap(step, "cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    grads = []
    for x, t in zip(inp["x"], inp["t"]):
        opt.zero_grad(set_to_none=True)
        loss = TT.call_bound(step, torch.bfloat16,
                             _rows(x, rank, world).to(torch.bfloat16),
                             _rows(t, rank, world))["total"]
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        opt.step()
    return {"grads": grads,
            "dtypes": {n: (p.dtype, p.grad.dtype)
                       for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()}}


class TinyDataset:
    """``n`` textured h x w RGB images with three elliptic masks each, the
    interface ``yolact_train_loop.train`` reads."""

    def __init__(self, n=12, h=48, w=64, g=3):
        rng = np.random.default_rng(0)
        self.image_ids = list(range(n))
        yy, xx = np.mgrid[:h, :w]
        self._data = {}
        for i in self.image_ids:
            wh = rng.uniform(0.3, 0.6, (g, 2)) * [w, h]
            xy = rng.uniform(0, 1, (g, 2)) * ([w, h] - wh)
            boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
            masks = np.stack([((xx - (a + c) / 2) / ((c - a) / 2)) ** 2
                              + ((yy - (b + d) / 2) / ((d - b) / 2)) ** 2 <= 1
                              for a, b, c, d in boxes]).astype(np.uint8)
            self._data[i] = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                             {"boxes": boxes, "classes": rng.integers(0, 3, g),
                              "masks": masks, "iscrowd": np.zeros(g, int)})

    def __len__(self):
        return len(self.image_ids)

    def load_image(self, i):
        return self._data[i][0].copy()

    def load_target(self, i):
        return {k: v.copy() for k, v in self._data[i][1].items()}


def train_loop_job(inp: dict, rank: int = 0, world: int = 1) -> dict:
    """``yolact_train_loop.train`` on :class:`TinyDataset`: ``steps`` steps
    at the global ``batch_size`` -> the history, the model's state after,
    whether BatchNorm was frozen and synchronised. The model and the
    uploaded batches in f64, so that two runs differ by f64 rounding."""
    from tpuseg_torch.engine import yolact_train_loop as TL
    from tpuseg_torch.models import yolact as Y
    from tpuseg_torch.parallel.sync_bn import SyncBatchNorm2d

    upload = TL.batch_to_device

    def upload64(images, targets, dev):
        x, t = upload(images, targets, dev)
        return x.double(), {k: v.double() if v.is_floating_point() else v
                            for k, v in t.items()}

    TL.batch_to_device = upload64
    out = []
    try:
        for batch_size, steps in inp["runs"]:
            model = Y.build_model(inp["cfg"])
            model.load_state_dict(inp["state"])
            model, it, hist = TL.train(
                TinyDataset(), inp["cfg"], batch_size=batch_size,
                max_steps=steps, save_every=10 ** 6, log_every=1,
                model=model.double(), device="cpu")
            out.append({"history": hist, "it": it,
                        "freeze_bn": model.freeze_bn,
                        "synced": any(isinstance(m, SyncBatchNorm2d)
                                      for m in model.modules()),
                        "state": {k: v.clone()
                                  for k, v in model.state_dict().items()}})
    finally:
        TL.batch_to_device = upload
    return out


JOBS = {"sync_bn": sync_bn_job, "yolact_step": yolact_step,
        "maskrcnn_step": maskrcnn_step, "collectives": collectives_job,
        "bf16_ddp": bf16_ddp_job, "train_loop": train_loop_job}


def main() -> None:
    import torch.distributed as dist

    job, tmp = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(2)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    try:
        out = JOBS[job](torch.load(tmp / f"{job}.in.pt", weights_only=False),
                        rank, world)
        torch.save(out, tmp / f"{job}.{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
