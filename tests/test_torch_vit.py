"""tpuseg_torch's ViT against tpuseg's, on the CPU, at a small size (32
px, patch 8, width 64, 3 layers, 4 heads): ``features`` and the logits,
``vit_preprocess``, the two checkpoint formats (jeonsworld ``.pth`` and
google-research ``.npz``) into both packages, the classifier's top-k,
one ``ViTTrainer`` step in f64 with and without label smoothing, and
``cosine_schedule``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.engine import vit_train as JT
from tpuseg.engine.classify import load_vit_weights as j_load
from tpuseg.nn import vit as JV
from tpuseg.ops.preprocess import vit_preprocess as j_preprocess
from tpuseg_torch.engine import vit_train as TT
from tpuseg_torch.engine.classify import ViTClassifier, load_vit_weights
from tpuseg_torch.nn import vit as TV
from tpuseg_torch.ops.preprocess import vit_preprocess
from tpuseg_torch.weights.from_jax import (vit_jax_from_state_dict,
                                           vit_state_dict_from_jax)

torch.set_num_threads(2)

SMALL = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=3,
             num_heads=4, mlp_dim=128, num_classes=10)


def random_state_dict(seed: int) -> dict:
    """The port's random init (seed) with LayerNorm and biases moved off
    their 1 / 0 starts, so every tensor's mapping shows."""
    sd = TV.build_model(TV.ViTConfig(**SMALL),
                        torch.Generator().manual_seed(seed)).state_dict()
    rng = np.random.default_rng(seed)
    for k, v in sd.items():
        if v.ndim == 1 or "cls_token" in k:
            v += torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(
                np.float32))
    return sd


def jax_params(sd: dict, dtype=jnp.float32) -> dict:
    return jax.tree.map(lambda a: jnp.asarray(a, dtype),
                        vit_jax_from_state_dict(sd))


def test_features_and_logits_match_tpuseg():
    """f32: the class embedding and the logits within 1e-5 of max|ref|."""
    cfg, jcfg = TV.ViTConfig(**SMALL), JV.ViTConfig(**SMALL)
    sd = random_state_dict(0)
    x = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(
        np.float32)
    params = jax_params(sd)
    model = TV.build_model(cfg)
    model.load_state_dict(sd)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = (model.features(xt).numpy(), model(xt).numpy())
    want = jax.jit(lambda p, x: (JV.features(p, x, jcfg),
                                 JV.forward(p, x, jcfg)))(params,
                                                          jnp.asarray(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_vit_preprocess_matches_tpuseg():
    """A downscale, an upscale and the identity, within 1e-6."""
    rng = np.random.default_rng(2)
    for h, w in ((50, 41), (20, 30), (32, 32)):
        img = rng.integers(0, 256, (2, h, w, 3)).astype(np.uint8)
        want = np.asarray(j_preprocess(jnp.asarray(img), size=32))
        got = vit_preprocess(torch.from_numpy(img), size=32)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=1e-6)


def google_npz(sd: dict, cfg: TV.ViTConfig) -> dict:
    """The port's state_dict written in google-research's npz layout."""
    d, h = cfg.hidden_size, cfg.num_heads
    g = {k: v.numpy() for k, v in sd.items()}
    out = {"embedding/kernel": g["transformer.embeddings.patch_embeddings"
                                 ".weight"].transpose(2, 3, 1, 0),
           "embedding/bias": g["transformer.embeddings.patch_embeddings.bias"],
           "cls": g["transformer.embeddings.cls_token"],
           "Transformer/posembed_input/pos_embedding":
               g["transformer.embeddings.position_embeddings"],
           "Transformer/encoder_norm/scale":
               g["transformer.encoder.encoder_norm.weight"],
           "Transformer/encoder_norm/bias":
               g["transformer.encoder.encoder_norm.bias"],
           "head/kernel": g["head.weight"].T, "head/bias": g["head.bias"]}
    for i in range(cfg.num_layers):
        src, dst = f"transformer.encoder.layer.{i}.", \
            f"Transformer/encoderblock_{i}/"
        for s, t in (("attention_norm", "LayerNorm_0"),
                     ("ffn_norm", "LayerNorm_2")):
            out[f"{dst}{t}/scale"] = g[f"{src}{s}.weight"]
            out[f"{dst}{t}/bias"] = g[f"{src}{s}.bias"]
        mha = dst + "MultiHeadDotProductAttention_1/"
        for name in ("query", "key", "value"):
            out[f"{mha}{name}/kernel"] = g[f"{src}attn.{name}.weight"].T \
                .reshape(d, h, d // h)
            out[f"{mha}{name}/bias"] = g[f"{src}attn.{name}.bias"].reshape(
                h, d // h)
        out[f"{mha}out/kernel"] = g[f"{src}attn.out.weight"].T.reshape(
            h, d // h, d)
        out[f"{mha}out/bias"] = g[f"{src}attn.out.bias"]
        for j, fc in enumerate(("fc1", "fc2")):
            out[f"{dst}MlpBlock_3/Dense_{j}/kernel"] = g[
                f"{src}ffn.{fc}.weight"].T
            out[f"{dst}MlpBlock_3/Dense_{j}/bias"] = g[f"{src}ffn.{fc}.bias"]
    return out


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_checkpoints_load_into_both_packages(tmp_path, fmt):
    """A jeonsworld .pth (with an extra key both ignore) and a
    google-research .npz of the same weights: each package's
    ``load_vit_weights`` reads it, the logits equal within 1e-5 of
    max|ref|, and the port's tensors equal the written ones."""
    cfg, jcfg = TV.ViTConfig(**SMALL), JV.ViTConfig(**SMALL)
    sd = random_state_dict(3)
    path = str(tmp_path / f"vit.{fmt}")
    if fmt == "pth":
        torch.save({**sd, "transformer.embeddings.dropout.p": torch.ones(1)},
                   path)
    else:
        np.savez(path, **google_npz(sd, cfg))
    got_sd = load_vit_weights(path, cfg)
    assert got_sd.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-7, err_msg=k)
    params = j_load(path, jcfg)
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    model = TV.build_model(cfg)
    model.load_state_dict(got_sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    want = np.asarray(jax.jit(lambda p, x: JV.forward(p, x, jcfg))(
        params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_classifier_top_k(tmp_path, monkeypatch):
    """ViTClassifier.run_on_image on a non-square image (resized on the
    host to the model's input): the top 5 of the softmax of the same
    forward, highest first."""
    from tpuseg_torch.data.image_io import resize_bilinear_u8
    from tpuseg_torch.engine import config as C

    sd = random_state_dict(5)
    path = str(tmp_path / "vit.pth")
    torch.save(sd, path)
    monkeypatch.setitem(C._REGISTRY, "vit_small_config",
                        C.get_config("vit_b16_config").copy(SMALL))
    clf = ViTClassifier("vit_small_config", path, device="cpu")
    img = np.random.default_rng(6).integers(0, 256, (45, 37, 3)).astype(
        np.uint8)
    ids, probs = clf.run_on_image(img, 5)
    x = vit_preprocess(torch.from_numpy(resize_bilinear_u8(img, 32, 32))[None],
                       size=32)
    with torch.no_grad():
        p = torch.softmax(clf.model(x), -1)[0].numpy()
    np.testing.assert_array_equal(ids, np.argsort(-p, kind="stable")[:5])
    np.testing.assert_allclose(probs, p[ids], rtol=1e-6)
    assert np.all(np.diff(probs) <= 0)


LR, WD, IT = 2e-2, 1e-4, 5


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_trainer_step_matches_tpuseg(smoothing):
    """One step in f64: the loss and accuracy, every gradient (recovered
    from tpuseg's first SGD update p' = p - lr (g + wd p)) and the update,
    rtol 1e-3 / atol 1e-5 max|g|. The key projections' biases get no
    gradient (softmax ignores a shift common to a row's logits): there
    both sides' gradients are rounding, below 1e-12 of the largest
    gradient, and the update is the weight decay's."""
    cfg, jcfg = TV.ViTConfig(**SMALL), JV.ViTConfig(**SMALL)
    sd = random_state_dict(7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 32, 32, 3))
    labels = rng.integers(0, 10, 4).astype(np.int32)
    lr_fn = TT.cosine_schedule(LR, 10, warmup=2)
    with jax.enable_x64(True):
        params = jax_params(sd, jnp.float64)
        jt = JT.ViTTrainer(jcfg, lr_fn=JT.cosine_schedule(LR, 10, warmup=2),
                           weight_decay=WD, label_smoothing=smoothing)
        new, _, metrics = jt.train_step(params, jt.init_state(params),
                                        jnp.asarray(x), jnp.asarray(labels),
                                        IT)
        lr = float(JT.cosine_schedule(LR, 10, warmup=2)(IT))
        delta = jax.tree.map(lambda a, b: np.asarray(a - b), new, params)
        grad = jax.tree.map(lambda d, p: -d / lr - WD * np.asarray(p), delta,
                            params)
        want = {"loss": float(metrics["loss"]), "acc": float(metrics["acc"]),
                "delta": vit_state_dict_from_jax(delta),
                "grad": vit_state_dict_from_jax(grad)}
    tt = TT.ViTTrainer(cfg, lr_fn=lr_fn, label_smoothing=smoothing,
                       state_dict=sd, device="cpu")
    assert tt.optimizer.defaults["weight_decay"] == WD
    tt.model.double()
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    out = tt.train_step(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(labels), IT)
    np.testing.assert_allclose(float(out["loss"]), want["loss"], rtol=1e-6)
    assert float(out["acc"]) == want["acc"]
    assert lr_fn(IT) == pytest.approx(lr, rel=1e-6)
    after = tt.model.state_dict()
    gmax = max(float(v.abs().max()) for v in want["grad"].values())
    for n, p in tt.model.named_parameters():
        jg = want["grad"][n].numpy()
        if n.endswith("attn.key.bias"):
            assert max(np.abs(jg).max(), float(p.grad.abs().max())) \
                < 1e-12 * gmax, n
        else:
            np.testing.assert_allclose(p.grad.numpy(), jg, rtol=1e-3,
                                       atol=1e-5 * np.abs(jg).max(),
                                       err_msg=f"grad {n}")
        jd = want["delta"][n].numpy()
        np.testing.assert_allclose((after[n] - before[n]).numpy(), jd,
                                   rtol=1e-3, atol=1e-5 * np.abs(jd).max(),
                                   err_msg=f"step {n}")


def test_cosine_schedule_matches_tpuseg():
    """At the start, inside the warm-up, at its end, after it and at the
    last step: within f32 rounding."""
    for base, total, warm in ((3e-2, 1000, 500), (0.1, 50, 0)):
        t, j = TT.cosine_schedule(base, total, warm), \
            JT.cosine_schedule(base, total, warm)
        for it in (0, 1, warm // 2, warm, warm + 1, total // 2, total - 1):
            np.testing.assert_allclose(t(it), float(j(it)), rtol=1e-6,
                                       atol=1e-12, err_msg=str(it))
