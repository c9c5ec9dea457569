"""The port's quant.py against the JAX package's, on the same seeded tree.

The JAX tree (tiny config, seeded noise on every leaf) is quantized by the
JAX package's ``quant.quantize_tree`` and carried into the port's layout by
``from_flax_params``; the port quantizes ``from_flax_params`` of the f32
tree itself. Tolerance: none, the int8 values and the f32 scales must be
bit-equal (both run the same f32 operations on the host), and so must the
dequantized trees in f32 and in bf16.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import seeded_params, to_port_config
from vilbert_multitask_tpu import quant as jquant
from vilbert_multitask_tpu.config import ViLBertConfig
from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.engine.flops import param_tree_bytes

CFG = ViLBertConfig().tiny()
PCFG = to_port_config(CFG)
POOLER = "bert.t_pooler.dense.weight"
WORD = "bert.embeddings.word_embeddings.weight"


@pytest.fixture(scope="module")
def tree():
    """Seeded f32 tree with a zero output column in a kernel and in an
    embedding table, and a column whose values sit exactly at ±127·scale
    (scale 1.0) and at half steps."""
    params = seeded_params(CFG, seed=3)
    kernel = params["bert"]["t_pooler"]["dense"]["kernel"]  # (in, out)
    kernel[:, 0] = 0.0
    kernel[:, 1] = 0.0
    kernel[:6, 1] = [127.0, -2.5, 3.5, 0.5, -0.5, -127.0]
    params["bert"]["embeddings"]["word_embeddings"]["embedding"][:, 2] = 0.0
    return params


def _equal_trees(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert quant.is_quantized_leaf(g) == quant.is_quantized_leaf(w), key
        if quant.is_quantized_leaf(w):
            for part in (quant.QVALUES, quant.QSCALE):
                gv, wv = np.asarray(g[part]), np.asarray(w[part])
                assert gv.dtype == wv.dtype, (key, part)
                np.testing.assert_array_equal(gv, wv, err_msg=f"{key}.{part}")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=key)


def test_quantize_tree_is_bit_equal_to_jax(tree):
    want = from_flax_params(jquant.quantize_tree(tree), PCFG)
    got = quant.quantize_tree(from_flax_params(tree, PCFG))
    _equal_trees(got, want)
    # Every matrix is a pair, every vector stays f32.
    for key, v in got.items():
        assert quant.is_quantized_leaf(v) == (np.ndim(
            from_flax_params(tree, PCFG)[key]) >= 2), key


def test_tensor_leaves_quantize_like_numpy_leaves(tree):
    sd = from_flax_params(tree, PCFG)
    as_tensors = quant.quantize_tree({k: torch.from_numpy(np.array(v))
                                      for k, v in sd.items()})
    _equal_trees({k: quant.leaf_to(v) for k, v in as_tensors.items()},
                 {k: quant.leaf_to(v) for k, v in quant.quantize_tree(
                     sd).items()})


def test_zero_channels_exact_extremes_and_half_steps(tree):
    q = quant.quantize_tree(from_flax_params(tree, PCFG))
    pooler = q[POOLER]  # (out, in): one scale per output row
    assert pooler[quant.QSCALE][0] == 1.0 and not pooler[quant.QVALUES][0].any()
    assert pooler[quant.QSCALE][1] == 1.0
    # ±127·scale map to ±127; half steps round to even: -2.5 → -2,
    # 3.5 → 4, 0.5 → 0, -0.5 → -0.
    np.testing.assert_array_equal(pooler[quant.QVALUES][1, :6],
                                  [127, -2, 4, 0, 0, -127])
    word = q[WORD]  # (rows, hidden): one scale per hidden column
    assert word[quant.QSCALE].shape == (CFG.hidden_size,)
    assert word[quant.QSCALE][2] == 1.0 and not word[quant.QVALUES][:, 2].any()
    _equal_trees({"d": q["cls.predictions.decoder.weight"]}, {"d": word})


def test_qkv_split_keeps_every_value_and_scale(tree):
    """The JAX model's fused qkv kernel, quantized per output column, split
    into the upstream query/key/value Linears: the same values and scales
    as the port quantizing each Linear on its own."""
    jpair = jquant.quantize_tree(tree)["bert"]["encoder"]["t_layer_0"][
        "attention"]["qkv"]["kernel"]
    port = quant.quantize_tree(from_flax_params(tree, PCFG))
    h = CFG.hidden_size
    for i, name in enumerate(("query", "key", "value")):
        pair = port[f"bert.encoder.layer.0.attention.self.{name}.weight"]
        np.testing.assert_array_equal(
            pair[quant.QVALUES], jpair["int8"][:, i * h:(i + 1) * h].T)
        np.testing.assert_array_equal(
            pair[quant.QSCALE], jpair["scale"][i * h:(i + 1) * h])


def test_double_cast_is_idempotent(tree):
    once = quant.quantize_tree(from_flax_params(tree, PCFG))
    twice = quant.quantize_tree(once)
    assert all(twice[k] is once[k] for k in once)
    _equal_trees(from_flax_params(jquant.quantize_tree(
        jquant.quantize_tree(tree)), PCFG), once)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_tree_is_bit_equal_to_jax(tree, dtype):
    jq = jquant.quantize_tree(tree)
    jd = from_flax_params(jquant.dequantize_tree(jq, jnp.dtype(dtype)), PCFG)
    got = quant.dequantize_tree(from_flax_params(jq, PCFG),
                                getattr(torch, dtype))
    assert set(got) == set(jd)
    for key, want in jd.items():
        g = got[key]
        assert g.dtype == getattr(torch, dtype), key
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(want, np.float32),
                                      err_msg=key)


def test_int8_bytes_are_under_035_of_f32(tree):
    sd = from_flax_params(tree, PCFG)
    ratio = param_tree_bytes(quant.quantize_tree(sd)) / param_tree_bytes(sd)
    assert ratio < 0.35, ratio


def test_tree_is_quantized_matches_pairs_not_names(tree):
    sd = from_flax_params(tree, PCFG)
    assert not quant.tree_is_quantized(sd)
    # LayerNorm leaves are named "scale" in the JAX tree: no pair.
    assert not quant.tree_is_quantized(tree)
    assert quant.tree_is_quantized(quant.quantize_tree(sd))
    assert quant.tree_is_quantized([{"a": {"int8": 1, "scale": 2}}])


@pytest.mark.parametrize("key,axis", [
    ("bert.embeddings.word_embeddings.weight", -1),
    ("bert.embeddings.position_embeddings.weight", -1),
    ("bert.embeddings.token_type_embeddings.weight", -1),
    ("bert.embeddings.task_embeddings.weight", -1),
    ("cls.predictions.decoder.weight", -1),
    ("bert.v_embeddings.image_embeddings.weight", 0),
    ("bert.v_embeddings.image_location_embeddings.weight", 0),
    ("vil_prediction.logit_fc.3.weight", 0),
])
def test_channel_axis(key, axis):
    assert quant.channel_axis(key) == axis
