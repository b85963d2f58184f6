"""Read a checkpoint file without executing anything from it (port of
``tpuseg/weights/torch_io.py::load_torch_file`` and ``flatten_state_dict``).

Formats, in the order tpuseg tries them:
  * a torch zip checkpoint (torch >= 1.6) and the legacy torch format:
    ``torch.load(weights_only=True)``;
  * anything else is read as a plain pickle (the Jittor-style ``.pkl`` of
    ``{name: np.ndarray}`` dicts, nested or not) by an unpickler whose
    ``find_class`` returns only the globals that rebuild numpy arrays,
    numpy scalars and dicts (``PICKLE_GLOBALS``) and raises on any other.
Arrays come back as CPU tensors.
"""
from __future__ import annotations

import pickle
import zipfile

import numpy as np
import torch

_LEGACY_MAGIC = 0x1950A86A20F9469CFC6C  # the first pickle of a legacy file

# (module, name) that a plain pickle of numpy arrays may name: the array's,
# dtype's and scalar's reconstruction (numpy < 2 and >= 2 spellings;
# ``_frombuffer`` is how protocol 5 writes an array) and the OrderedDict of
# a state_dict
PICKLE_GLOBALS = frozenset(
    [(f"numpy.{core}.multiarray", name) for core in ("core", "_core")
     for name in ("_reconstruct", "scalar")]
    + [(f"numpy.{core}.numeric", "_frombuffer") for core in ("core", "_core")]
    + [("numpy", "ndarray"), ("numpy", "dtype"),
       ("collections", "OrderedDict")])


class _NoGlobals(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"global {module}.{name}")


class _ArrayUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in PICKLE_GLOBALS or module == "numpy.dtypes":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint pickle names {module}.{name}: only numpy arrays, "
            "numpy scalars and dicts are read")


def _is_legacy(path) -> bool:
    """True if the file's first pickle is the legacy format's magic number
    (read by an unpickler that allows no globals)."""
    with open(path, "rb") as f:
        try:
            return _NoGlobals(f).load() == _LEGACY_MAGIC
        except Exception:  # noqa: BLE001 - any unreadable head: not legacy
            return False


def _to_tensors(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj.astype(obj.dtype.newbyteorder("="),
                                           order="C", copy=False))
    if isinstance(obj, dict):
        return type(obj)((k, _to_tensors(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_tensors(v) for v in obj)
    return obj


def load_torch_file(path):
    """A torch zip or legacy checkpoint, or a plain pickle of numpy arrays
    -> the nested structure it holds, arrays as CPU tensors."""
    if zipfile.is_zipfile(path) or _is_legacy(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        return _to_tensors(_ArrayUnpickler(f).load())


def flatten_state_dict(obj, prefix: str = "") -> dict:
    """A loaded checkpoint -> ``{dotted name: tensor}``: unwraps the
    containers ``state_dict``, ``model``, ``weights`` and ``params`` (in
    that order), flattens nested dicts, drops scalars and other metadata."""
    for key in ("state_dict", "model", "weights", "params"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    out = {}

    def rec(o, pre):
        if isinstance(o, torch.Tensor):
            out[pre.rstrip(".")] = o
        elif isinstance(o, dict):
            for k, v in o.items():
                rec(v, f"{pre}{k}.")

    rec(obj, prefix)
    return out
