"""Shared plumbing of the tests that hold the PyTorch port
(``vilbert_multitask_tpu_torch``) against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both
packages; the JAX parameter tree crosses over through the port's own
``checkpoint.convert.from_flax_params``. Only tests import both packages.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vilbert_multitask_tpu.config import ViLBertConfig
from vilbert_multitask_tpu.models.vilbert import (
    ViLBertForVLTasks as JaxViLBert,
)
from vilbert_multitask_tpu_torch import config as port_config
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.models.vilbert import (
    ViLBertForVLTasks as PortViLBert,
)

# Tier-1 runs the suite in several pytest-xdist workers on a few cores.
torch.set_num_threads(2)

OUTPUT_FIELDS = ("vil_prediction", "vil_prediction_gqa", "vil_logit",
                 "vil_binary_prediction", "vil_tri_prediction",
                 "vision_prediction", "vision_logit", "linguisic_prediction",
                 "linguisic_logit")
INPUT_ORDER = ("input_ids", "features", "spatials", "segment_ids",
               "input_mask", "image_mask")


def to_port_config(cfg: ViLBertConfig, **overrides):
    """The same configuration as the port's own dataclass (same fields)."""
    return dataclasses.replace(
        port_config.ViLBertConfig(**dataclasses.asdict(cfg)), **overrides)


def model_inputs(cfg: ViLBertConfig, *, batch: int = 2, n_text: int = 9,
                 n_regions: int = 7, seed: int = 1) -> dict:
    """Seeded numpy inputs with masked text and region tails."""
    rng = np.random.default_rng(seed)
    input_mask = np.ones((batch, n_text), np.int32)
    input_mask[:, n_text - 2:] = 0
    image_mask = np.ones((batch, n_regions), np.int32)
    image_mask[:, n_regions - 3:] = 0
    return dict(
        input_ids=rng.integers(0, cfg.vocab_size, (batch, n_text)).astype(
            np.int32),
        features=rng.normal(size=(batch, n_regions, cfg.v_feature_size)
                            ).astype(np.float32),
        spatials=rng.random((batch, n_regions, 5)).astype(np.float32),
        segment_ids=np.zeros((batch, n_text), np.int32),
        input_mask=input_mask,
        image_mask=image_mask,
        task_ids=rng.integers(1, 17, (batch, 1)).astype(np.int32),
    )


def seeded_params(cfg: ViLBertConfig, seed: int = 0,
                  scale: float = 0.1) -> dict:
    """The JAX model's init tree (f32 numpy) with seeded noise on every
    leaf, so zero-initialized biases and unit LayerNorm scales are
    exercised too."""
    inp = model_inputs(cfg, seed=seed)
    model = JaxViLBert(cfg, dtype=jnp.float32)
    init = jax.jit(lambda key, args, task_ids: model.init(
        key, *args, None, task_ids, deterministic=True)["params"])
    params = init(jax.random.PRNGKey(seed),
                  tuple(jnp.asarray(inp[k]) for k in INPUT_ORDER),
                  jnp.asarray(inp["task_ids"]))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + scale * rng.normal(size=x.shape).astype(np.float32)),
        params)


def jax_forward(cfg: ViLBertConfig, params: dict, inp: dict, *,
                dtype=np.float32, pallas: bool = False,
                collect: bool = False) -> dict:
    """JAX ``ViLBertForVLTasks`` forward (all heads) → numpy dict. The
    Pallas kernel, when on, runs in interpret mode on the CPU."""
    cfg = dataclasses.replace(cfg, use_pallas_coattention=pallas,
                              use_pallas_self_attention=pallas)
    f64 = np.dtype(dtype) == np.float64
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        tree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
        model = JaxViLBert(cfg, dtype=jdt)
        apply = jax.jit(lambda tree, args, task_ids: model.apply(
            {"params": tree}, *args, None, task_ids, deterministic=True,
            output_all_attention_masks=collect))
        out = apply(tree,
                    tuple(jnp.asarray(inp[k], jdt if k in ("features",
                                                           "spatials")
                                      else jnp.int32) for k in INPUT_ORDER),
                    jnp.asarray(inp["task_ids"], jnp.int32))
        return _as_numpy(out)


def port_model(cfg: ViLBertConfig, params: dict, *, dtype=torch.float32,
               pallas: bool = True) -> PortViLBert:
    """The port's model on the CPU with the JAX tree loaded (strict)."""
    pcfg = to_port_config(cfg, use_pallas_coattention=pallas,
                          use_pallas_self_attention=pallas)
    model = PortViLBert(pcfg)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in from_flax_params(params, pcfg).items()}
    model.load_state_dict(sd, strict=True)
    return model.to(dtype).eval()


def port_inputs(inp: dict, dtype=torch.float32) -> tuple:
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inp.items()}
    return (t["input_ids"].long(), t["features"].to(dtype),
            t["spatials"].to(dtype), t["segment_ids"].long(),
            t["input_mask"].long(), t["image_mask"].long(), None,
            t["task_ids"].long())


def port_forward(model: PortViLBert, inp: dict, *, dtype=torch.float32,
                 collect: bool = False) -> dict:
    with torch.inference_mode():
        out = model(*port_inputs(inp, dtype),
                    output_all_attention_masks=collect)
    return _as_numpy(out)


def _as_numpy(out) -> dict:
    def conv(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.float().numpy() if x.dtype == torch.bfloat16 \
                else x.numpy()
        return np.asarray(x)

    res = {f: conv(getattr(out, f)) for f in OUTPUT_FIELDS}
    res["attn_data_list"] = [tuple(conv(p) for p in pair)
                             for pair in out.attn_data_list]
    return res


def assert_outputs_close(got: dict, want: dict, *, atol: float,
                         rtol: float) -> None:
    """All ten outputs agree: same presence, shapes and values."""
    for f in OUTPUT_FIELDS:
        g, w = got[f], want[f]
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.shape == w.shape, (f, g.shape, w.shape)
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                       err_msg=f)
    assert len(got["attn_data_list"]) == len(want["attn_data_list"])
    for i, (gp, wp) in enumerate(zip(got["attn_data_list"],
                                     want["attn_data_list"])):
        for g, w in zip(gp, wp):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                           err_msg=f"attn_data_list[{i}]")


# ----------------------------------------------------------- engine worlds
def write_feature_files(root, dim: int, names, *, seed: int = 0) -> None:
    """Seeded reference-format ``.npy`` region files, one per name, with
    5-10 boxes each (more than ``num_features=8`` clips)."""
    from vilbert_multitask_tpu.features.pipeline import RegionFeatures
    from vilbert_multitask_tpu.features.store import save_reference_npy

    rng = np.random.default_rng(seed)
    for i, name in enumerate(names):
        n = 10 if i == 0 else 5 + i % 4
        x1 = rng.uniform(0, 300, n)
        y1 = rng.uniform(0, 200, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(10, 200, n),
                          y1 + rng.uniform(10, 150, n)], 1)
        save_reference_npy(f"{root}/{name}.npy", RegionFeatures(
            features=rng.normal(size=(n, dim)).astype(np.float32),
            boxes=boxes.astype(np.float32), image_width=640,
            image_height=480), name)


def engine_pair(jax_cfg, feature_root: str, *, seed: int = 0,
                **port_engine):
    """A JAX engine (dense attention, noisy seeded weights) and the port's
    CPU engine on the same converted weights, the same feature files and
    the same config (the port's through ``FrameworkConfig.from_dict``, its
    kernel routes on, which take the plain version on the CPU)."""
    from vilbert_multitask_tpu.engine.runtime import (
        InferenceEngine as JaxEngine,
    )
    from vilbert_multitask_tpu.features.store import FeatureStore as JaxStore
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine as PortEngine,
    )
    from vilbert_multitask_tpu_torch.features.store import (
        FeatureStore as PortStore,
    )

    jeng = JaxEngine(jax_cfg, seed=seed, feature_store=JaxStore(feature_root))
    noise = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.1 * noise.normal(size=x.shape).astype(np.float32),
        jax.device_get(jeng.params))
    jeng.load_params(params)
    pcfg = port_config.FrameworkConfig.from_dict(dataclasses.asdict(jax_cfg))
    pcfg = dataclasses.replace(pcfg, engine=dataclasses.replace(
        pcfg.engine, use_pallas_coattention=True,
        use_pallas_self_attention=True, **port_engine))
    sd = from_flax_params(params, pcfg.model)
    peng = PortEngine(pcfg, params=sd, feature_store=PortStore(feature_root),
                      device="cpu")
    return jeng, peng, sd


def assert_same_result(got, want, tol, path="result"):
    """Same structure, strings and ints; floats to ``tol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same_result(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_result(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, err_msg=path, **tol)
    else:
        assert got == want, (path, got, want)


# ----------------------------------------------------------------- detector
def random_boxes(rng, n: int, *, ties: bool = False, extent: float = 100.0):
    """(n, 4) xyxy f32 boxes inside ``extent`` (sides 1-60, so many
    overlap) and (n,) f32 scores in [0, 1); ``ties`` rounds the scores to
    fifths, so most of them tie."""
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(1, 60, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.random(n)
    if ties:
        scores = np.round(scores * 5) / 5
    return boxes, scores.astype(np.float32)


def detector_params(cfg, seed: int = 0, noise: float = 0.05) -> dict:
    """The JAX ``FasterRCNN``'s init tree for ``cfg`` (f32 numpy) with seeded
    noise on every leaf, then the two scales the port's seeded init applies
    (``detect.model.init_state_dict``: stem FrozenBN 1/64, each block's bn3
    0.2), so the RPN sigmoids and class scores spread instead of
    saturating."""
    from vilbert_multitask_tpu.detect.model import FasterRCNN as JaxRCNN

    c = cfg.canvas
    model = JaxRCNN(cfg)
    params = jax.jit(lambda key: model.init(
        key, jnp.zeros((c, c, 3), jnp.float32),
        jnp.asarray([c, c], jnp.float32))["params"])(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x, np.float32)
                   + noise * rng.normal(size=x.shape).astype(np.float32)),
        params)
    params["backbone"]["stem_bn"]["scale"] /= 64.0
    for name, block in params["backbone"].items():
        if name.startswith("stage"):
            block["bn3"]["scale"] *= 0.2
    return params


def maskrcnn_state_dict(params: dict, cfg) -> dict:
    """A maskrcnn_benchmark-layout detector state dict (numpy) holding the
    same function as the Flax tree ``params``: the JAX package's
    ``to_torch_state_dict`` (torchvision-style keys, FrozenBN as weight /
    bias with zero mean and unit variance), with fc6's inputs put in
    maskrcnn's (C, res, res) flatten order."""
    from vilbert_multitask_tpu.detect.convert import to_torch_state_dict

    sd = to_torch_state_dict(params, cfg)
    res, ch = cfg.roi_resolution, cfg.fpn_channels
    kernel = np.asarray(params["fc6"]["kernel"])  # (res·res·C, D)
    sd["roi_heads.box.feature_extractor.fc6.weight"] = np.ascontiguousarray(
        kernel.reshape(res, res, ch, -1).transpose(3, 2, 0, 1).reshape(
            kernel.shape[1], -1))
    return sd
