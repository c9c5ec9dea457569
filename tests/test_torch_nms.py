"""The port's NMS and region selection (``vilbert_multitask_tpu_torch.ops.
nms``) against the JAX package's (``vilbert_multitask_tpu.ops.nms``), on
the CPU, where the wrappers run their plain versions (the CUDA kernel,
``csrc/nms.cu``, is held to the plain version on the card by chip_smoke.py).

Keep masks and the selection's outputs must be bit-equal: both sides compute
the same f32 IoUs in the same order and walk the boxes in the same order
(descending score, ties by index).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import random_boxes
from vilbert_multitask_tpu.ops import nms as jnms
from vilbert_multitask_tpu_torch.ops import nms as pnms


def _jax_mask(boxes, scores, thresh):
    return np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                    thresh))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 300, 1000])
def test_nms_mask_bit_equal_to_jax(n, ties):
    boxes, scores = random_boxes(np.random.default_rng(n), n, ties=ties)
    kept = {}
    for thresh in (0.5, 0.7):
        want = _jax_mask(boxes, scores, thresh)
        got = pnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                            thresh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"thresh {thresh}")
        kept[thresh] = int(got.sum())
    if n >= 63:  # the walk both keeps and suppresses
        assert 0 < kept[0.5] < n and kept[0.5] <= kept[0.7]


def test_nms_mask_at_the_exact_threshold():
    """IoUs exactly 0.5 (binary fractions, so no rounding on either side)
    are not suppressed at threshold 0.5; one a hair above is."""
    boxes = np.array([
        [0.0, 0.0, 4.0, 2.0],    # area 8
        [0.0, 0.0, 4.0, 1.0],    # IoU with box 0: 4 / 8 = 0.5 exactly
        [0.0, 0.0, 2.0, 2.0],    # IoU with box 0: 4 / 8 = 0.5 exactly
        [0.0, 0.0, 4.0, 1.0625],  # IoU with box 0: 4.25 / 8 > 0.5
        [10.0, 10.0, 11.0, 11.0],  # disjoint
    ], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.6, 0.5], np.float32)
    want = _jax_mask(boxes, scores, 0.5)
    got = pnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.5).numpy()
    np.testing.assert_array_equal(got, want)
    # box 1 and box 2 overlap each other at 2 / 8 = 0.25: kept at 0.5
    np.testing.assert_array_equal(got, [True, True, True, False, True])
    got_q = pnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                          0.25).numpy()
    np.testing.assert_array_equal(got_q, _jax_mask(boxes, scores, 0.25))


def test_nms_mask_identical_and_disjoint_boxes():
    same = np.tile(np.array([[1.0, 2.0, 5.0, 9.0]], np.float32), (65, 1))
    scores = np.random.default_rng(3).random(65).astype(np.float32)
    got = pnms.nms_mask(torch.from_numpy(same), torch.from_numpy(scores))
    assert got.sum() == 1 and got[int(np.argmax(scores))]
    grid = np.array([[4.0 * i, 0.0, 4.0 * i + 2.0, 2.0] for i in range(70)],
                    np.float32)
    assert pnms.nms_mask(torch.from_numpy(grid),
                         torch.from_numpy(scores[:1].repeat(70))).all()


def test_batched_groups_with_valid_counts_match_per_group_jax():
    """(G, N) groups, each its own boxes and a ragged valid count (the RPN
    levels' shape): every group's mask equals JAX on its first ``valid``
    boxes alone, and the padding is never kept."""
    rng = np.random.default_rng(7)
    counts = [130, 3, 64, 1, 97]
    N = max(counts)
    boxes = np.zeros((len(counts), N, 4), np.float32)
    scores = np.zeros((len(counts), N), np.float32)
    for g, k in enumerate(counts):
        b, s = random_boxes(rng, k, ties=g % 2 == 1)
        boxes[g, :k], scores[g, :k] = b, s
        # junk in the padding that would suppress valid boxes if read
        boxes[g, k:] = [0.0, 0.0, 100.0, 100.0]
        scores[g, k:] = 2.0
    got = pnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                        0.7, valid=counts).numpy()
    for g, k in enumerate(counts):
        np.testing.assert_array_equal(
            got[g, :k], _jax_mask(boxes[g, :k], scores[g, :k], 0.7))
        assert not got[g, k:].any()


def test_shared_boxes_equal_per_group_copies():
    """One box set shared by every group (a stride-0 view) gives the same
    masks as the groups' own copies."""
    rng = np.random.default_rng(11)
    boxes, _ = random_boxes(rng, 90)
    scores = rng.random((6, 90)).astype(np.float32)
    b = torch.from_numpy(boxes)
    shared = pnms.nms_mask(b.expand(6, 90, 4), torch.from_numpy(scores))
    copies = pnms.nms_mask(b.repeat(6, 1, 1), torch.from_numpy(scores))
    assert torch.equal(shared, copies)
    for g in range(6):
        np.testing.assert_array_equal(shared[g].numpy(),
                                      _jax_mask(boxes, scores[g], 0.5))


def test_box_iou_matches_jax():
    rng = np.random.default_rng(5)
    a, _ = random_boxes(rng, 40)
    b, _ = random_boxes(rng, 33)
    want = np.asarray(jnms.box_iou(jnp.asarray(a), jnp.asarray(b)))
    got = pnms.box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_top_k_breaks_ties_by_index_like_lax(k):
    x = np.array([0.5, 0.0, 0.5, 1.0, 0.0, 0.5, 0.0, 1.0, 0.25, 0.0, 0.0,
                  0.5, 0.25, 0.0, 1.0, 0.0, 0.5], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(x), k)
    gv, gi = pnms.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.fixture(scope="module")
def selection_inputs():
    """300 proposals × 1601 softmaxed classes (the serving shape)."""
    rng = np.random.default_rng(0)
    boxes, _ = random_boxes(rng, 300)
    logits = rng.normal(scale=2.0, size=(300, 1601))
    scores = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize("quantile", [None, 0.8])
def test_select_top_regions_bit_equal_to_jax(selection_inputs, quantile):
    """At conf_threshold 0 (the extractor's) and at one that only a fifth
    of the boxes' best scores pass."""
    boxes, scores = selection_inputs
    conf_threshold = 0.0 if quantile is None else float(
        np.quantile(scores[:, 1:].max(axis=1), quantile))
    want = [np.asarray(x) for x in jnms.select_top_regions(
        jnp.asarray(boxes), jnp.asarray(scores),
        conf_threshold=conf_threshold)]
    got = [x.numpy() for x in pnms.select_top_regions(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        conf_threshold=conf_threshold)]
    names = ("keep_indices", "num_valid", "max_conf", "objects", "cls_prob")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if conf_threshold:
        assert 0 < int(got[1]) < 100  # the threshold bites


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    boxes, scores = random_boxes(np.random.default_rng(2), 50)
    pnms.nms_mask.launches = 0
    got = pnms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores))
    want = pnms.nms_mask_plain(torch.from_numpy(boxes),
                               torch.from_numpy(scores))
    assert torch.equal(got, want) and pnms.nms_mask.launches == 0


@pytest.mark.parametrize("bad", ["scores_3d", "boxes_shape", "valid_shape",
                                 "device"])
def test_wrapper_rejects_bad_inputs(bad):
    boxes = torch.zeros(4, 10, 4)
    scores = torch.zeros(4, 10)
    kw = {}
    if bad == "scores_3d":
        scores = scores[None]
    elif bad == "boxes_shape":
        boxes = torch.zeros(4, 9, 4)
    elif bad == "valid_shape":
        kw["valid"] = [1, 2]
    else:
        boxes, scores = boxes.to("meta"), scores.to("meta")
    with pytest.raises(ValueError):
        pnms.nms_mask(boxes, scores, **kw)
