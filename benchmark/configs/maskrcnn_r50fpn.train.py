"""Mask R-CNN R-50-FPN's training cells: the port's loop ``do_train`` at the
mix's batch over its dataset, and what the training window
(``windows/train.py``) asks of a configuration."""
from __future__ import annotations

import numpy as np
import torch
from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
from tpuseg_torch.engine import detectron_train_loop as TL

from benchmark.configs import maskrcnn_r50fpn as C
from benchmark.reference.frozen import detectron_data as DD

NEVER = 1 << 62  # a checkpoint or log period that never comes

STEP_FN = (TL, "train_step")

train_state = C.initial_state
make_model = C.make_model


def step_generator(args, kwargs):
    """The samplers' generator that ``train_step`` was handed."""
    return kwargs["generator"] if "generator" in kwargs else args[6]


def train_spans(data) -> dict:
    """The harness's spans of a traced run: (owner, function, synchronise
    at its end)."""
    return {"batch_build": [(TL, "build_train_example", False),
                            (TL, "batch_to_device", False)],
            "step": [(TL, "train_step", True)]}


def program_dataset(data_dir):
    return CocoDetectionDataset(str(data_dir / "images"),
                                str(data_dir / "instances.json"))


def canvas_of(info: dict) -> str:
    return "landscape" if info["width"] >= info["height"] else "portrait"


def warm_steps(data_dir, mix: dict, seed: int) -> int:
    """Set-up steps: up to the one by which each canvas orientation has run
    twice (the loop's own order, from the seed)."""
    data = DD.CocoData(str(data_dir / "images"), str(data_dir / "instances.json"))
    plan = DD.batch_plan(data, seed, mix["batch"], 4 * len(data.image_ids))
    seen = {}
    for k, chunk in enumerate(plan, 1):
        orient = canvas_of(data.imgs[chunk[0][0]])
        seen[orient] = seen.get(orient, 0) + 1
        if len(seen) == 2 and min(seen.values()) >= 2:
            return k
    raise ValueError("the dataset has a single canvas orientation")


def flops_per_step(model, data, sizes: dict, mix: dict, dev) -> float:
    """Model FLOPs of one training forward and backward at the cell's
    batch, counted by ``FlopCounterMode`` on the landscape canvas."""
    from torch.utils.flop_counter import FlopCounterMode

    ids = [i for i in data.image_ids
           if canvas_of(data.coco.imgs[i]) == "landscape"][:mix["batch"]]
    rng = np.random.default_rng(0)
    batch = TL.batch_to_device(
        [TL.build_train_example(data, i, sizes["min_size_train"],
                                sizes["max_size_train"], rng=rng)
         for i in ids], dev)
    counter = FlopCounterMode(display=False)
    with counter:
        losses = TL.train_losses(model, *batch,
                                 torch.Generator(device=dev).manual_seed(0))
        losses["total"].backward()
    model.zero_grad(set_to_none=True)
    return float(counter.get_total_flops())


def train(model, data, sizes: dict, mix: dict, seed: int, dev,
          compute_dtype=None) -> None:
    """The port's ``do_train`` at the cell's batch, from the seed; it runs
    until the harness's step hook ends it."""
    TL.do_train(data, model.cfg, model=model, base_lr=sizes["base_lr"],
                ims_per_batch=mix["batch"], checkpoint_period=NEVER,
                log_every=NEVER, seed=seed, device=dev,
                min_size=sizes["min_size_train"],
                max_size=sizes["max_size_train"], compute_dtype=compute_dtype)
