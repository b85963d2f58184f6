"""The plain reference of Mask R-CNN R-50-FPN training: maskrcnn-benchmark's
e2e 1x solver on batches it builds itself from the dataset's files, in
float32 with TF32 off, through ``frozen/`` (copies of the port's plain
code: the plain NMS and RoIAlign, no kernel). It follows the first steps
from the benchmark's initial weights, and one step of the window from the
program's parameters and samplers' generator before it. It imports
nothing of the port."""
from __future__ import annotations

import math

import torch

from benchmark.reference import maskrcnn_r50fpn as R
from benchmark.reference.exact import float32_exact
from benchmark.reference.frozen import detectron_data as DD
from benchmark.reference.frozen import maskrcnn as M

BIAS_LR_FACTOR = 2.0
MOMENTUM = 0.9
WEIGHT_DECAY = 1e-4
# the RPN's losses: its anchors' labels and samples come from the gt
# boxes and the draws alone, so no rounding of the network moves them
STEADY_TERMS = ("loss_objectness", "loss_rpn_box_reg")


def warmup_lr(base_lr: float, it: int, warmup_factor=1.0 / 3,
              warmup_iters=500) -> float:
    """WarmupMultiStepLR before its first step: linear warm-up."""
    if it >= warmup_iters:
        return base_lr
    alpha = it / warmup_iters
    return base_lr * (warmup_factor * (1 - alpha) + alpha)


def optimizer(model, base_lr: float) -> torch.optim.SGD:
    """maskrcnn-benchmark's groups: weights with decay, biases at twice the
    lr without; frozen parameters left out."""
    weights, biases = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (biases if name.endswith("bias") else weights).append(p)
    return torch.optim.SGD(
        [{"params": weights, "lr_factor": 1.0, "weight_decay": WEIGHT_DECAY},
         {"params": biases, "lr_factor": BIAS_LR_FACTOR, "weight_decay": 0.0}],
        lr=base_lr, momentum=MOMENTUM)


def leaf_norms(named) -> dict:
    return {n: float(t.double().norm()) for n, t in named}


def build(sizes: dict, state: dict, dev):
    model = M.build_model(R.model_config(sizes))
    model.load_state_dict(state, strict=True)
    return model.to(dev).train()


def batch(data, chunk, sizes: dict, dev) -> tuple:
    return DD.batch_to_device(
        [DD.build_train_example(data, iid, flip, sizes["min_size_train"],
                                sizes["max_size_train"])
         for iid, flip in chunk], dev)


def train_steps(data_dir, state: dict, sizes: dict, mix: dict, seed: int,
                dev, steps: int = 3) -> dict:
    """``steps`` SGD steps from ``state`` (the initial state dict, on the
    host) -> {"losses": total loss per step, "terms": each step's losses,
    "grad_norms": each trainable leaf's first gradient norm,
    "change_norms": each leaf's |p_steps - p_0|}. The samplers draw from a
    generator on ``dev`` seeded with ``seed``, as the loop's do."""
    with float32_exact():
        data = DD.CocoData(str(data_dir / "images"),
                           str(data_dir / "instances.json"))
        model = build(sizes, state, dev)
        opt = optimizer(model, sizes["base_lr"])
        gen = torch.Generator(device=dev).manual_seed(seed)
        terms, grad_norms = [], None
        for it, chunk in enumerate(DD.batch_plan(data, seed, mix["batch"],
                                                 steps)):
            images, hw, targets = batch(data, chunk, sizes, dev)
            for g in opt.param_groups:
                g["lr"] = warmup_lr(sizes["base_lr"], it) * g["lr_factor"]
            out = M.forward_train_losses(model, images, hw, targets,
                                         generator=gen)
            opt.zero_grad(set_to_none=True)
            out["total"].backward()
            if it == 0:
                grad_norms = leaf_norms((n, p.grad) for n, p in
                                        model.named_parameters()
                                        if p.requires_grad)
            opt.step()
            terms.append({k: float(v.detach()) for k, v in out.items()})
        change = {n: float((p.detach().cpu().double()
                            - state[n].double()).norm())
                  for n, p in model.named_parameters() if p.requires_grad}
        losses = [step["total"] for step in terms]
        if not all(math.isfinite(v) for v in losses):
            raise FloatingPointError(f"reference losses {losses}")
        return {"losses": losses, "terms": terms, "grad_norms": grad_norms,
                "change_norms": change}


def window_step(data_dir, state: dict, before: dict, sizes: dict, mix: dict,
                seed: int, dev, step: int) -> dict:
    """Step ``step`` (1-based) of the loop from the program's state before
    it: ``before["params"]`` (the trainable leaves; the frozen ones are
    ``state``'s) and ``before["generator"]`` (the samplers' generator), on
    the batch this reference builds from the files in the loop's order ->
    {"terms": the step's losses, "grad_norms": each trainable leaf's
    gradient norm}."""
    with float32_exact():
        data = DD.CocoData(str(data_dir / "images"),
                           str(data_dir / "instances.json"))
        model = build(sizes, dict(state, **before["params"]), dev)
        gen = torch.Generator(device=dev)
        gen.set_state(before["generator"])
        chunk = DD.batch_plan(data, seed, mix["batch"], step)[step - 1]
        images, hw, targets = batch(data, chunk, sizes, dev)
        out = M.forward_train_losses(model, images, hw, targets,
                                     generator=gen)
        out["total"].backward()
        terms = {k: float(v.detach()) for k, v in out.items()}
        if not math.isfinite(terms["total"]):
            raise FloatingPointError(f"reference losses {terms}")
        return {"terms": terms, "grad_norms": leaf_norms(
            (n, p.grad) for n, p in model.named_parameters()
            if p.requires_grad)}
