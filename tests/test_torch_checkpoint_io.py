"""The port's checkpoint reader (``tpuseg_torch/weights/torch_io.py``)
against tpuseg's (``tpuseg/weights/torch_io.py``: ``load_torch_file`` +
``flatten_state_dict``) on files this test writes: torch zip and legacy
checkpoints, bare and in each container tpuseg unwraps, nested dicts, and
plain pickles of numpy arrays (the Jittor-style ``.pkl``). The key sets must
be equal and the arrays equal to the bit. A pickle that names any other
global is refused without running it. And the two loaders on top of it:
``load_detectron_weights`` reads a pickled container, and YOLACT's
``train(resume=...)`` accepts a checkpoint with upstream's extra
``fpn.downsample_layers.2.*`` keys, as tpuseg's resume does."""
import dataclasses
import os
import pickle
from collections import OrderedDict
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from tpuseg.weights import torch_io as jio
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.engine import yolact_train_loop as TL
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.weights import torch_io as tio
from tpuseg_torch.weights.detectron_map import load_detectron_weights

torch.set_num_threads(2)


def _arrays(seed: int) -> dict:
    """A small state_dict's arrays: f32, f64, f16, int64 (0-d, as
    BatchNorm's ``num_batches_tracked``), int32, uint8 and bool."""
    rng = np.random.default_rng(seed)
    return {"backbone.conv1.weight": rng.standard_normal((4, 3, 3, 3))
            .astype(np.float32),
            "backbone.bn1.running_var": rng.uniform(0.5, 2, 4),
            "fpn.lat.bias": rng.standard_normal(5).astype(np.float16),
            "backbone.bn1.num_batches_tracked": np.array(7, np.int64),
            "head.idx": rng.integers(-9, 9, (2, 3)).astype(np.int32),
            "head.bytes": rng.integers(0, 255, 6).astype(np.uint8),
            "head.mask": rng.uniform(size=4) < 0.5}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def _tensors(d):
    if isinstance(d, dict):
        return OrderedDict((k, _tensors(v)) for k, v in d.items())
    return torch.from_numpy(d.copy()) if isinstance(d, np.ndarray) else d


def _wrap(sd, container):
    """``sd`` bare, or in ``container`` beside scalar and string metadata
    that the flattening drops."""
    if container is None:
        return sd
    return {"iteration": 90000, "lr": 0.02, "name": "e2e", container: sd}


def _write(path, obj, fmt: str) -> None:
    if fmt == "zip":
        torch.save(_tensors(obj), path)
    elif fmt == "legacy":
        torch.save(_tensors(obj), path, _use_new_zipfile_serialization=False)
    else:  # "pickle<protocol>": a plain pickle of numpy arrays in an
        # OrderedDict, as a state_dict comes, with a numpy scalar beside them
        obj = OrderedDict(obj, epoch=np.int64(3))
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=int(fmt[len("pickle"):]))


def _assert_same(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    for k, want in ref.items():
        got = port[k]
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu", k
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == np.ascontiguousarray(want).tobytes(), k


@pytest.mark.parametrize("fmt", ["zip", "legacy", "pickle4", "pickle5"])
@pytest.mark.parametrize("layout", [None, "model", "state_dict", "weights",
                                    "params", "nested"])
def test_reader_matches_tpuseg(tmp_path, fmt, layout):
    """Each file through both readers: the same names, the same bits."""
    arrays = _arrays(len(fmt) + len(str(layout)))
    obj = _nest(arrays) if layout == "nested" else _wrap(
        arrays, layout)
    path = tmp_path / "ckpt.pth"
    _write(path, obj, fmt)
    ref = jio.flatten_state_dict(jio.load_torch_file(str(path)))
    port = tio.flatten_state_dict(tio.load_torch_file(str(path)))
    assert set(ref) == set(arrays)
    _assert_same(port, ref)


class _Shell:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


@pytest.mark.parametrize("protocol", [4, 5])
def test_reader_refuses_a_pickle_with_other_globals(tmp_path, protocol):
    """A pickle whose arrays sit beside an ``os.system`` call: refused,
    and the call is not made."""
    marker = tmp_path / "ran"
    path = tmp_path / "evil.pkl"
    with open(path, "wb") as f:
        pickle.dump({"w": np.zeros(3, np.float32), "x": _Shell(marker)}, f,
                    protocol=protocol)
    with pytest.raises(pickle.UnpicklingError, match="os.system|posix.system"):
        tio.load_torch_file(str(path))
    assert not marker.exists()


def test_detectron_loader_reads_a_pickled_container(tmp_path):
    """``load_detectron_weights`` on a plain pickle of a ``model``
    container with DataParallel's ``module.`` names: the weights land,
    the FrozenBatchNorm statistics the file omits default to 0 / 1."""
    rng = np.random.default_rng(5)
    model = nn.Sequential(nn.Conv2d(3, 4, 3), FrozenBatchNorm2d(4))
    arrays = {"0.weight": rng.standard_normal((4, 3, 3, 3)).astype(np.float32),
              "0.bias": rng.standard_normal(4).astype(np.float32),
              "1.weight": rng.uniform(0.5, 2, 4).astype(np.float32),
              "1.bias": rng.standard_normal(4).astype(np.float32)}
    path = tmp_path / "model_final.pkl"
    _write(path, {"model": {f"module.{k}": v for k, v in arrays.items()},
                  "iteration": 90000}, "pickle4")
    load_detectron_weights(str(path), model)
    sd = model.state_dict()
    for k, v in arrays.items():
        assert torch.equal(sd[k], torch.from_numpy(v)), k
    assert torch.equal(sd["1.running_mean"], torch.zeros(4))
    assert torch.equal(sd["1.running_var"], torch.ones(4))


def test_yolact_resume_takes_upstream_extra_downsample_layers(tmp_path):
    """A yolact_resnet50 state_dict with upstream's third
    ``fpn.downsample_layers`` (which the FPN here does not have) resumes:
    its parameters land, the extra layer is dropped, and the iteration
    comes from the ``<cfg>_<epoch>_<iter>.pth`` name."""
    cfg = dataclasses.replace(yolact_model_config("yolact_resnet50"),
                              img_size=64, num_classes=4)
    sd = Y.build_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    extra = {"fpn.downsample_layers.2.weight": torch.randn(256, 256, 3, 3),
             "fpn.downsample_layers.2.bias": torch.randn(256)}
    path = tmp_path / "yolact_resnet50_1_5.pth"
    torch.save({**sd, **extra}, path)
    data = SimpleNamespace(image_ids=[0, 1])
    model, it, hist = TL.train(data, cfg, batch_size=2, resume=str(path),
                               max_steps=0, device="cpu")
    assert it == 5 and hist == []
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
