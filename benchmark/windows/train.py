"""The training window: the port's own loop, driven from the seed, counted
from outside by ``torch.optim``'s global step hooks. End-to-end metrics:
``setup_s`` and ``train_img_s``.

One call of the configuration's loop serves set-up and window. Its first
steps are set-up: the step hooks read the first step's gradient from the
optimizer's momentum buffers (SGD's first buffer is the gradient plus the
weight decay term) and the parameters after step 3, and the step function
is wrapped to keep the first steps' losses. Set-up ends after the step by
which every canvas shape of the cell has run twice; the window then runs
until the first step that ends ``seconds`` after it began (the second at
the least), which ends the loop by raising from the hook. The device is
synchronised at both ends.

The window's first step is kept for the check too: the parameters, the
momentum buffers and the samplers' generator before it (read at the end
of set-up), its losses, and the momentum buffers after it (a copy on the
device, the only work the check adds to the window), from which the
gradient the optimizer got is worked out once the window has closed.
"""
from __future__ import annotations

import time

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook
from tpuseg_torch import kernels

from benchmark.common import card, dataset
from benchmark.common.spans import Spans

CHECKED_STEPS = 3  # the steps the reference follows from the start


class StopWindow(Exception):
    """Raised from the step hook when the window has closed."""


def sgd_params(opt):
    """(parameter, its group) of an SGD optimizer with plain momentum."""
    for group in opt.param_groups:
        if group.get("dampening", 0.0) or group.get("nesterov", False):
            raise ValueError("the check reads plain SGD momentum")
        for p in group["params"]:
            yield p, group


def first_grad_norms(opt, names: dict) -> dict:
    """Each parameter's first gradient, worked out from SGD's state after
    one step: buf = g + wd * p0 and p1 = p0 - lr * buf."""
    out = {}
    for p, group in sgd_params(opt):
        buf = opt.state.get(p, {}).get("momentum_buffer")
        if buf is None:
            continue
        wd, lr = group.get("weight_decay", 0.0), group["lr"]
        p0 = p.detach() + lr * buf
        out[names[id(p)]] = float((buf - wd * p0).double().norm())
    return out


def step_grad_norms(opt, names: dict, before: dict, after: dict) -> dict:
    """Each parameter's gradient in one later step, worked out from SGD's
    state around it: buf1 = momentum * buf0 + g + wd * p0."""
    out = {}
    for p, group in sgd_params(opt):
        n = names[id(p)]
        if n not in after:
            continue
        g = (after[n].double() - group["momentum"] * before["momentum"][n].double()
             - group.get("weight_decay", 0.0) * before["params"][n].double())
        out[n] = float(g.norm())
    return out


def buckets(times, t0: float, width: float) -> list:
    """How many of ``times`` fall in each ``width`` seconds from ``t0``."""
    out = []
    for t in times:
        i = int((t - t0) // width)
        out += [0] * (i + 1 - len(out))
        out[i] += 1
    return out


def run(cfg_mod, sizes: dict, mix: dict, seed: int,
        seconds: float, trace: bool, dev, t_start: float,
        compute_dtype=None) -> dict:
    """One training run -> what the metrics and the check read."""
    marks = [("start", time.perf_counter())]
    data_dir = dataset.ensure(mix["dataset"])
    marks.append(("dataset", time.perf_counter()))
    state = cfg_mod.train_state(sizes, seed, dev)
    state_host = {k: v.detach().cpu() for k, v in state.items()}
    model = cfg_mod.make_model(sizes, state, dev)
    del state
    data = cfg_mod.program_dataset(data_dir)
    warm = max(cfg_mod.warm_steps(data_dir, mix, seed), CHECKED_STEPS + 1)
    marks.append(("weights and model", time.perf_counter()))
    names = {id(p): n for n, p in model.named_parameters()}
    spans = Spans(sync_ok=trace and dev.type == "cuda")
    flops = cfg_mod.flops_per_step(model, data, sizes, mix, dev) if trace else None
    marks.append(("flop count", time.perf_counter()))
    cap = {"losses": [], "grad_norms": {}, "change_norms": {}, "window": {}}
    st = {"steps": 0, "calls": 0, "t0": None, "t1": None, "prof": None,
          "ends": []}
    calls, counts = {}, {}
    undo_calls = None

    owner, attr = cfg_mod.STEP_FN

    def keep_losses(fn):
        def step(*args, **kwargs):
            st["calls"] += 1
            if st["calls"] == warm + 1:
                cap["window"]["generator"] = cfg_mod.step_generator(
                    args, kwargs).get_state()
            out = fn(*args, **kwargs)
            if len(cap["losses"]) < CHECKED_STEPS:
                cap["losses"].append({k: v.detach().clone()
                                      for k, v in out.items()})
            if st["calls"] == warm + 1:
                cap["window"]["terms"] = {k: v.detach().clone()
                                          for k, v in out.items()}
            return out
        return step

    spans.patch(owner, attr, keep_losses)
    if trace:
        for name, targets in cfg_mod.train_spans(data).items():
            for target_owner, target_attr, sync in targets:
                spans.wrap(target_owner, target_attr, name, sync)

    def hook(opt, args, kwargs):
        nonlocal undo_calls
        st["steps"] += 1
        k = st["steps"]
        spans.item = k + 1
        if k == 1:
            cap["grad_norms"] = first_grad_norms(opt, names)
        if k == CHECKED_STEPS:
            cap["change_norms"] = {
                names[id(p)]: float((p.detach().cpu().double()
                                     - state_host[names[id(p)]].double()).norm())
                for p, _ in sgd_params(opt)}
        if k == warm:
            cap["window"]["params"] = {
                names[id(p)]: p.detach().to("cpu", copy=True)
                for p, _ in sgd_params(opt)}
            cap["window"]["momentum"] = {
                names[id(p)]: opt.state[p]["momentum_buffer"].to("cpu",
                                                                 copy=True)
                for p, _ in sgd_params(opt) if p in opt.state}
            card.sync(dev)
            if trace:
                from benchmark.common import kernel_calls

                undo_calls = kernel_calls.record(calls, counts)
                st["prof"] = card.profiler(dev)
                st["prof"].__enter__()
            st["launches0"] = kernels.launch_counts()
            st["t0"] = time.perf_counter()
        elif k > warm:
            if k == warm + 1:
                cap["window"]["after"] = {
                    names[id(p)]: opt.state[p]["momentum_buffer"].clone()
                    for p, _ in sgd_params(opt) if p in opt.state}
                st["opt"] = opt
            now = time.perf_counter()
            st["ends"].append(now)
            if now - st["t0"] >= seconds and k > warm + 1:
                raise StopWindow

    handle = register_optimizer_step_post_hook(hook)
    try:
        cfg_mod.train(model, data, sizes, mix, seed, dev, compute_dtype)
    except StopWindow:
        pass
    finally:
        handle.remove()
        card.sync(dev)
        st["t1"] = time.perf_counter()
        if st["prof"] is not None:
            st["prof"].__exit__(None, None, None)
        if undo_calls is not None:
            undo_calls()
        spans.restore()
    if st["t0"] is None or "opt" not in st:
        raise RuntimeError(f"the loop ended after {st['steps']} steps, "
                           f"before the window's first ({warm} set-up steps)")
    steps = st["steps"] - warm
    launches = {k: v - st["launches0"][k]
                for k, v in kernels.launch_counts().items()}
    peak = card.memory_peak(dev)
    win = cap["window"]
    after = {n: b.cpu() for n, b in win.pop("after").items()}
    win["grad_norms"] = step_grad_norms(st.pop("opt"), names, win, after)
    win["terms"] = {k: float(v) for k, v in win["terms"].items()}
    del after
    terms = [{k: float(v) for k, v in step.items()} for step in cap["losses"]]
    del model, data
    card.free(dev)
    window = st["t1"] - st["t0"]
    marks.append((f"{warm} set-up steps", st["t0"]))
    setup_log = ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                          in zip([("", t_start)] + marks, marks))
    return {
        "log": [f"set-up: {setup_log}",
                "steps a 5 s of the window: " + str(buckets(
                    st["ends"], st["t0"], 5.0))],
        "setup_s": st["t0"] - t_start, "window_s": window,
        "e2e": {"setup_s": st["t0"] - t_start,
                "train_img_s": steps * mix["batch"] / window},
        "item_name": "steps", "t0": st["t0"], "t1": st["t1"], "items": steps,
        "images": steps * mix["batch"], "batch": mix["batch"], "peak": peak,
        "spans": spans, "prof": st["prof"], "calls": calls, "counts": counts,
        "flops_per_item": flops, "launches": launches, "data_dir": data_dir,
        "state_host": state_host, "window_step": warm + 1, "program": {
            "losses": [step["total"] for step in terms], "terms": terms,
            "grad_norms": cap["grad_norms"],
            "change_norms": cap["change_norms"], "window": win},
        "failed": 0,
    }


def check(ref_mod, run: dict, sizes: dict, mix: dict, seed: int, dev) -> tuple:
    """The reference's first steps from the same initial state and the
    window's first step from the program's state before it, then the
    numbers compared (``common/check.py``)."""
    from benchmark.common import check as C

    prog = run["program"]
    ref = ref_mod.train_steps(run["data_dir"], run["state_host"], sizes, mix,
                              seed, dev, CHECKED_STEPS)
    ref["window"] = ref_mod.window_step(
        run["data_dir"], run["state_host"], prog["window"], sizes, mix, seed,
        dev, run["window_step"])
    return C.train_numbers(prog, ref, ref_mod.STEADY_TERMS)
