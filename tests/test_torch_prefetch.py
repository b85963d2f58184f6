"""tpuseg_torch.data.prefetch.DevicePrefetcher against tpuseg's on the CPU:
order, completeness, error propagation, zero batches, and each batch equal
to load_fn's (as tensors)."""
import numpy as np
import pytest
import torch

from tpuseg.data.prefetch import DevicePrefetcher as JPrefetcher
from tpuseg_torch.data.prefetch import DevicePrefetcher


def _batch(i):
    """A YOLACT-like host batch: images and a dict of targets."""
    rng = np.random.default_rng(i)
    return (rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8),
            {"boxes": rng.random((2, 4, 4)).astype(np.float32),
             "classes": np.full((2, 4), i, np.int32),
             "crowd": rng.random((2, 4)) < 0.5,
             "flipped": rng.random((2, 8, 8)).astype(np.float32)[:, ::-1]})


def test_batches_equal_load_fn_and_tpuseg():
    got = list(DevicePrefetcher(_batch, 5, depth=2, device="cpu"))
    want = list(JPrefetcher(_batch, 5, depth=2))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        host = _batch(i)
        assert isinstance(g, tuple) and g[1].keys() == host[1].keys()
        for t, h, j in ([(g[0], host[0], w[0])]
                        + [(g[1][k], host[1][k], w[1][k]) for k in host[1]]):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), h)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert t.numpy().dtype == h.dtype


@pytest.mark.parametrize("depth", [1, 3])
def test_yields_all_batches_in_order(depth):
    def load(i):
        return np.full((4, 3), i, np.int32)

    got = [int(b[0, 0]) for b in DevicePrefetcher(load, 7, depth, "cpu")]
    want = [int(np.asarray(b)[0, 0]) for b in JPrefetcher(load, 7, depth)]
    assert got == want == list(range(7))


def test_propagates_load_errors():
    def load(i):
        if i == 2:
            raise ValueError("decode failed")
        return np.zeros((2,), np.float32)

    for cls, kw in ((DevicePrefetcher, {"device": "cpu"}), (JPrefetcher, {})):
        out = []
        with pytest.raises(ValueError, match="decode failed"):
            for b in cls(load, 5, **kw):
                out.append(b)
        assert len(out) == 2


def test_zero_batches():
    assert list(DevicePrefetcher(lambda i: np.zeros(1), 0,
                                 device="cpu")) == []
    assert list(JPrefetcher(lambda i: np.zeros(1), 0)) == []


def test_defaults_to_the_card():
    import inspect

    sig = inspect.signature(DevicePrefetcher.__init__)
    assert sig.parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DevicePrefetcher(lambda i: np.zeros(1), 1)
