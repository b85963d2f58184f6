"""The card: its presence, its name and power limit, and the check that
no JAX module was loaded (``chip_smoke.py::nvidia_smi``'s copy)."""
from __future__ import annotations

import subprocess
import sys

# top-level module names that no run may load, compared whole: the port's
# name begins with the JAX package's, so a prefix test would be wrong
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuseg")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def require_cards(n: int) -> None:
    """Raise unless CUDA is there with at least ``n`` cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs only on the card")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"{torch.cuda.device_count()} CUDA devices, the cell "
                         f"needs {n}")


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them (copied
    from ``chip_smoke.py::nvidia_smi``); '' where it does not run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def sync(dev) -> None:
    """Wait for the device's queued work (nothing to wait for on a CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def profiler(dev):
    """A ``torch.profiler.profile`` of the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def free(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
