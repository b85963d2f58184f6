"""ResNet body + FPN of tpuseg_torch against tpuseg's resnet.forward and
fpn_forward, on the same random weights (narrow: width 8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.nn import fpn as jfpn
from tpuseg.nn import resnet as jresnet
from tpuseg.weights import detectron_map as jmap
from tpuseg_torch.nn.fpn import FPN, Backbone
from tpuseg_torch.nn.resnet import ResNet

TOL = dict(rtol=1e-4, atol=1e-4)
WIDTH = 8


def random_state(module: torch.nn.Module, rng) -> dict:
    """Random values for every tensor of ``module``'s state_dict, by key:
    FrozenBN stats stay positive, conv weights scale with 1/sqrt(fan)."""
    sd = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("running_var") or (k.endswith(".weight") and len(shape) == 1):
            a = rng.uniform(0.7, 1.3, shape)
        elif k.endswith(".weight"):
            a = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        else:  # biases, running means
            a = rng.standard_normal(shape) * 0.05
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    body = ResNet(50, width=WIDTH)
    model = Backbone(body, FPN(body.out_channels, 32)).eval()
    sd = random_state(model, rng)
    model.load_state_dict(sd, strict=True)
    flat = {f"backbone.{k}": v.numpy() for k, v in sd.items()}
    params = {
        "backbone": jmap.map_resnet_body(flat, 50),
        "fpn": {
            "inner": [jmap._conv(flat, f"backbone.fpn.fpn_inner{i}")
                      for i in range(1, 5)],
            "layer": [jmap._conv(flat, f"backbone.fpn.fpn_layer{i}")
                      for i in range(1, 5)],
        },
    }
    x = (rng.standard_normal((2, 3, 64, 96)) * 40.0).astype(np.float32)
    return model, params, x


def test_resnet_and_fpn_match_jax(setup):
    model, params, x = setup
    rcfg = jresnet.ResNetConfig(depth=50, stride_in_1x1=True, frozen_bn=True,
                                width=WIDTH)

    @jax.jit
    def jax_fwd(p, img):
        feats = jresnet.forward(p["backbone"], img, rcfg)
        return feats, jfpn.fpn_forward(p["fpn"], feats, with_p6=True)

    jfeats, jpyr = jax_fwd(jax.tree.map(jnp.asarray, params),
                           jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.inference_mode():
        feats = model.body(torch.from_numpy(x))
        pyr = model.fpn(feats)
    for i, f in enumerate(feats):
        np.testing.assert_allclose(
            f.permute(0, 2, 3, 1).numpy(), np.asarray(jfeats[f"c{i + 2}"]),
            err_msg=f"c{i + 2}", **TOL)
    assert len(pyr) == 5
    for i, p in enumerate(pyr):
        np.testing.assert_allclose(
            p.permute(0, 2, 3, 1).numpy(), np.asarray(jpyr[f"p{i + 2}"]),
            err_msg=f"p{i + 2}", **TOL)
