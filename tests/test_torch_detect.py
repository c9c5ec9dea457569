"""The port's detector (``vilbert_multitask_tpu_torch.detect``,
``features/extract.py``) against the JAX package's, on the CPU with the
tiny config: the same seeded Flax weights on both sides (carried by the
port's ``detect.convert.from_flax_params``), the same numpy inputs.

- box math (anchors, decoding) and the FPN level rule: equal;
- ROIAlign over four levels against the JAX function box by box: 1e-6;
- preprocessing against the JAX one (PIL's resize): within one uint8 level;
- the detector's forward against ``FasterRCNN.apply``: proposals, class
  scores and fc6 at rtol/atol 1e-4 (f32, another summation order), row by
  row, so the same proposals were selected in the same order;
- the live extractor against the JAX extractor on the same canvas;
- the maskrcnn checkpoint loader: FrozenBN folded as ``fold_bn``, and fc6
  read in maskrcnn's (C, res, res) flatten order, which the JAX package's
  loader does not do (a reference-side fault, ROADMAP C).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import (
    detector_params,
    maskrcnn_state_dict,
    random_boxes,
)
from vilbert_multitask_tpu.config import DetectorConfig as JaxDetectorConfig
from vilbert_multitask_tpu.detect import convert as jconvert
from vilbert_multitask_tpu.detect import model as jmodel
from vilbert_multitask_tpu.detect.extractor import (
    LiveFeatureExtractor as JaxExtractor,
)
from vilbert_multitask_tpu.features.extract import (
    preprocess_image as jax_preprocess,
)
from vilbert_multitask_tpu_torch.config import DetectorConfig
from vilbert_multitask_tpu_torch.detect import convert as pconvert
from vilbert_multitask_tpu_torch.detect import model as pmodel
from vilbert_multitask_tpu_torch.detect.extractor import LiveFeatureExtractor
from vilbert_multitask_tpu_torch.features.extract import preprocess_image

F32 = dict(rtol=1e-4, atol=1e-4)
JCFG = JaxDetectorConfig().tiny()
PCFG = DetectorConfig().tiny()


@pytest.fixture(scope="module")
def params():
    return detector_params(JCFG)


@pytest.fixture(scope="module")
def jax_extractor(params):
    return JaxExtractor(JCFG, params=params, num_keep=10)


@pytest.fixture(scope="module")
def port_extractor(params):
    return LiveFeatureExtractor(
        PCFG, params=pconvert.from_flax_params(params, PCFG), num_keep=10,
        device="cpu")


def canvas_input(seed: int, h: int = 48, w: int = 40):
    """A BGR mean-subtracted canvas with a valid (h, w) corner."""
    rng = np.random.default_rng(seed)
    c = PCFG.canvas
    img = np.zeros((c, c, 3), np.float32)
    img[:h, :w] = rng.uniform(-120.0, 130.0, (h, w, 3))
    return img, np.asarray([h, w], np.float32)


def test_config_matches_the_jax_package():
    assert dataclasses.asdict(PCFG) == dataclasses.asdict(JCFG)
    assert (dataclasses.asdict(DetectorConfig())
            == dataclasses.asdict(JaxDetectorConfig()))


@pytest.mark.parametrize("level", range(5))
def test_anchors_equal_jax(level):
    cfg = JaxDetectorConfig()
    h = w = 1344 // pmodel.FPN_STRIDES[level]
    args = (h, w, pmodel.FPN_STRIDES[level], cfg.anchor_sizes[level],
            cfg.aspect_ratios)
    np.testing.assert_array_equal(pmodel.make_anchors(*args),
                                  jmodel.make_anchors(*args))


def test_decode_boxes_match_jax_and_clamp():
    rng = np.random.default_rng(0)
    anchors = pmodel.make_anchors(4, 5, 16, 64, (0.5, 1.0, 2.0))
    deltas = rng.normal(scale=1.5, size=(anchors.shape[0], 4)).astype(
        np.float32)
    deltas[:7, 2:] = 9.0  # past log(1000/16): clamped on both sides
    want = np.asarray(jmodel.decode_boxes(jnp.asarray(anchors),
                                          jnp.asarray(deltas)))
    got = pmodel.decode_boxes(torch.from_numpy(anchors),
                              torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert np.isfinite(got).all()


def _roi_inputs(seed: int):
    """Level maps of a 256 canvas (64², 32², 16², 8² × 16 channels) and
    boxes that reach every level: random ones, boxes on the level
    boundaries (sqrt(area) = 112, 224, 448), boxes off the canvas edge and
    zero-area ones."""
    rng = np.random.default_rng(seed)
    maps = [rng.normal(size=(256 // s, 256 // s, 16)).astype(np.float32)
            for s in pmodel.FPN_STRIDES[:4]]
    boxes, _ = random_boxes(rng, 40, extent=200.0)
    special = np.array([
        [10.0, 10.0, 122.0, 122.0],    # sqrt(area) 112: P3/P2 boundary
        [0.0, 0.0, 224.0, 224.0],      # 224: P4
        [5.0, 5.0, 453.0, 453.0],      # 448: P5, past the canvas
        [-30.0, -20.0, 40.0, 60.0],    # off the top-left edge
        [240.0, 250.0, 300.0, 290.0],  # off the bottom-right edge
        [50.0, 50.0, 50.0, 50.0],      # zero area
        [60.0, 70.0, 60.0, 90.0],      # zero width
        [0.0, 0.0, 1000.0, 30.0],      # long and thin
    ], np.float32)
    return maps, np.concatenate([boxes, special])


def _jax_roi(maps, boxes, res, samp):
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    level = np.asarray(jnp.clip(jnp.floor(4 + jnp.log2(jnp.sqrt(
        jnp.maximum(jnp.asarray(area), 1.0)) / 224.0)), 2, 5)).astype(int) - 2
    out = np.zeros((len(boxes), res, res, maps[0].shape[-1]), np.float32)
    for lvl in range(4):
        sel = level == lvl
        if sel.any():
            out[sel] = np.asarray(jmodel.roi_align(
                jnp.asarray(maps[lvl]), jnp.asarray(boxes[sel]),
                float(pmodel.FPN_STRIDES[lvl]), res, samp))
    return level, out


@pytest.mark.parametrize("res,samp", [(3, 2), (7, 2), (2, 1)])
def test_roi_align_with_levels_matches_jax(res, samp):
    maps, boxes = _roi_inputs(res * 10 + samp)
    level, want = _jax_roi(maps, boxes, res, samp)
    tb = torch.from_numpy(boxes)
    np.testing.assert_array_equal(pmodel.fpn_level(tb).numpy(), level)
    assert set(level) == {0, 1, 2, 3}
    got = pmodel.roi_align([torch.from_numpy(m) for m in maps], tb,
                           pmodel.FPN_STRIDES[:4], res, samp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_roi_align_reads_channels_last_maps_in_place():
    """The FPN's channels-last NCHW maps, permuted to (H, W, C), are views
    (no copy) and pool the same as contiguous copies."""
    maps, boxes = _roi_inputs(5)
    nchw = [torch.from_numpy(m).permute(2, 0, 1)[None].contiguous(
        memory_format=torch.channels_last) for m in maps]
    views = [t.permute(0, 2, 3, 1)[0] for t in nchw]
    assert all(v.is_contiguous() for v in views)
    a = pmodel.roi_align(views, torch.from_numpy(boxes),
                         pmodel.FPN_STRIDES[:4], 3, 2)
    b = pmodel.roi_align([torch.from_numpy(m) for m in maps],
                         torch.from_numpy(boxes), pmodel.FPN_STRIDES[:4], 3, 2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("hw", [(50, 40), (480, 640), (800, 1333),
                                (1500, 2000)],
                         ids=["small", "640x480", "1333x800", "2000x1500"])
def test_preprocess_within_one_level_of_pil(hw):
    """Upscaled, downscaled and unscaled images: every pixel within one
    uint8 level of PIL's resize (the JAX function), on random and smooth
    images; the share of pixels off by one is printed and stays small."""
    h, w = hw
    rng = np.random.default_rng(h)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                       (xx + yy) % 256], -1).astype(np.uint8)
    for name, img in (("random", rng.integers(0, 256, (h, w, 3), np.uint8)),
                      ("smooth", smooth)):
        want, scale_j = jax_preprocess(img)
        got, scale_p = preprocess_image(img)
        assert scale_p == scale_j and tuple(got.shape) == want.shape
        diff = np.abs(got.numpy() - want)
        share = float((diff > 0.5).mean())
        print(f"preprocess {h}x{w} {name}: max {diff.max():.3f} levels, "
              f"{share:.5f} of values off by one")
        assert diff.max() <= 1.0 + 1e-4
        assert share < 0.05


def test_forward_matches_jax(params, jax_extractor):
    img, hw = canvas_input(0)
    want = [np.asarray(x) for x in jax_extractor._fwd(
        jax_extractor.params, jnp.asarray(img), jnp.asarray(hw))]
    model = pmodel.FasterRCNN(PCFG)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           pconvert.from_flax_params(params, PCFG).items()},
                          strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.inference_mode():
        got = [x.numpy() for x in model(torch.from_numpy(img),
                                        tuple(float(v) for v in hw))]
    for name, g, w in zip(("proposals", "cls", "fc6"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **F32)
    # the scores spread: not saturated at 0 / 1, not all tied
    assert len(np.unique(got[1])) > got[1].size // 2
    assert 0.01 < got[1].max() < 0.99


def test_extract_array_matches_jax_extractor(jax_extractor, port_extractor):
    """A 48x64 image needs no resize at the tiny canvas, so both sides see
    the same padded canvas."""
    rgb = np.random.default_rng(9).integers(0, 256, (48, 64, 3), np.uint8)
    want = jax_extractor.extract_array(rgb)
    got = port_extractor.extract_array(rgb)
    assert got.num_boxes == want.num_boxes
    assert (got.image_width, got.image_height) == (64, 48)
    np.testing.assert_allclose(got.boxes, want.boxes, **F32)
    np.testing.assert_allclose(got.features, want.features, **F32)
    np.testing.assert_allclose(got.cls_prob, want.cls_prob, **F32)
    again = port_extractor.extract_array(rgb)
    np.testing.assert_array_equal(again.features, got.features)


def test_extractor_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveFeatureExtractor(PCFG, device="cuda")


def test_seeded_init_loads_and_spreads_scores():
    ex = LiveFeatureExtractor(PCFG, seed=3, num_keep=10, device="cpu")
    region = ex.extract_array(
        np.random.default_rng(1).integers(0, 256, (50, 40, 3), np.uint8))
    assert 1 <= region.num_boxes <= 10
    assert region.features.shape == (region.num_boxes,
                                     PCFG.representation_size)
    assert np.isfinite(region.features).all()
    assert region.cls_prob.shape == (region.num_boxes, PCFG.num_classes)
    assert 0.01 < region.cls_prob.max() < 0.99


# ------------------------------------------------------- checkpoint loader
def test_from_flax_params_covers_the_module_tree(params):
    sd = pconvert.from_flax_params(params, PCFG)
    assert set(sd) == set(pmodel.FasterRCNN(PCFG).state_dict())


def test_fold_bn_matches_the_jax_fold():
    rng = np.random.default_rng(4)
    w, b, m = (rng.normal(size=8).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    for ours, theirs in zip(pconvert.fold_bn(w, b, m, v),
                            jconvert.fold_bn(w, b, m, v)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.fixture(scope="module")
def maskrcnn_checkpoint(params, tmp_path_factory):
    """A synthetic maskrcnn-layout checkpoint: the same function as
    ``params``, with random BatchNorm statistics (scales rescaled to
    match), wrapped in ``{"model": ...}`` with ``module.`` prefixes."""
    sd = maskrcnn_state_dict(params, JCFG)
    rng = np.random.default_rng(6)
    for key in [k for k in sd if k.endswith(".running_var")]:
        prefix = key[:-len(".running_var")]
        var = rng.uniform(0.5, 2.0, sd[key].shape).astype(np.float32)
        mean = rng.normal(size=var.shape).astype(np.float32)
        scale = sd[f"{prefix}.weight"] / np.sqrt(np.float32(1.0 + 1e-5))
        sd[key], sd[f"{prefix}.running_mean"] = var, mean
        sd[f"{prefix}.weight"] = scale * np.sqrt(var + np.float32(1e-5))
        sd[f"{prefix}.bias"] = sd[f"{prefix}.bias"] + mean * scale
    sd["roi_heads.box.predictor.bbox_pred.weight"] = np.zeros((28, 32),
                                                              np.float32)
    path = tmp_path_factory.mktemp("det") / "model_final.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    return str(path), sd


def test_load_torch_detector_reads_fc6_in_maskrcnn_order(
        params, maskrcnn_checkpoint):
    """The port loaded from a maskrcnn-layout file computes what an oracle
    computes from the plain pieces with maskrcnn's (C, res, res) flatten;
    the JAX package's loader, on the same file, does not."""
    path, sd = maskrcnn_checkpoint
    loaded = pconvert.load_torch_detector(path, PCFG)
    assert set(loaded) == set(pmodel.FasterRCNN(PCFG).state_dict())
    ex = LiveFeatureExtractor(PCFG, params=loaded, device="cpu")
    img, hw = canvas_input(2)
    image = torch.from_numpy(img)
    hw = tuple(float(v) for v in hw)
    with torch.inference_mode():
        proposals, cls, fc6 = ex.model(image, hw)
        # the oracle: the plain pieces, and maskrcnn's fc6 as stored
        feats = ex.model.features(image)
        maps = [f.permute(0, 2, 3, 1)[0] for f in feats[:4]]
        pooled = pmodel.roi_align_plain(maps, proposals,
                                        pmodel.FPN_STRIDES[:4],
                                        PCFG.roi_resolution,
                                        PCFG.roi_sampling)
        flat_c_first = pooled.permute(0, 3, 1, 2).reshape(len(pooled), -1)
        w6 = torch.from_numpy(sd["roi_heads.box.feature_extractor.fc6.weight"])
        b6 = torch.from_numpy(sd["roi_heads.box.feature_extractor.fc6.bias"])
        oracle = torch.relu(flat_c_first @ w6.T + b6)
    np.testing.assert_allclose(fc6.numpy(), oracle.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the folded weights equal the Flax tree's (the fold of the rescaled
    # statistics undoes the rescaling, up to rounding)
    ref = pconvert.from_flax_params(params, PCFG)
    for k, v in loaded.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    # the JAX package's loader keeps maskrcnn's column order in its
    # (res, res, C)-flattening model: its fc6 is another function
    jparams = jconvert.load_torch_detector(path, JCFG)
    _, _, jfc6 = JaxExtractor(JCFG, params=jparams)._fwd(
        jparams, jnp.asarray(img), jnp.asarray(hw, jnp.float32))
    err = float(np.abs(np.asarray(jfc6) - oracle.numpy()).max())
    print(f"JAX load_torch_detector fc6 vs the (C, res, res) oracle: "
          f"max abs error {err:.4f} (oracle max {oracle.abs().max():.4f})")
    assert err > 1e-2


def test_load_torch_detector_is_strict(maskrcnn_checkpoint, tmp_path):
    _, sd = maskrcnn_checkpoint
    partial = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()
               if not k.startswith("rpn.head.conv")}
    path = tmp_path / "partial.pth"
    torch.save(partial, path)
    with pytest.raises(KeyError, match="lacks 2 mapped keys"):
        pconvert.load_torch_detector(str(path), PCFG)


def test_offline_cli_writes_the_jax_feature_files(tmp_path):
    """``features/extract.py:main`` on detector dumps (run on the CPU)
    writes the same reference-schema ``.npy`` files as the JAX CLI."""
    from vilbert_multitask_tpu.features.extract import (
        extract_one as jax_extract_one,
    )
    from vilbert_multitask_tpu_torch.features.extract import main

    rng = np.random.default_rng(8)
    raw = tmp_path / "raw"
    raw.mkdir()
    for k in range(2):
        boxes, _ = random_boxes(rng, 60, extent=400.0)
        logits = rng.normal(scale=2.0, size=(60, 9))
        scores = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
        np.savez(raw / f"img_{k}.npz", boxes=boxes,
                 cls_scores=scores.astype(np.float32),
                 features=rng.normal(size=(60, 16)).astype(np.float32),
                 image_width=640, image_height=480)
    main(["--raw", str(raw), "--out", str(tmp_path / "port"),
          "--num-keep", "20", "--device", "cpu"])
    for k in range(2):
        want_path = jax_extract_one(str(raw / f"img_{k}.npz"),
                                    str(tmp_path / "jax"), num_keep=20)
        want = np.load(want_path, allow_pickle=True).item()
        got = np.load(tmp_path / "port" / f"img_{k}.npy",
                      allow_pickle=True).item()
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
