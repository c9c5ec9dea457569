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


def test_select_top_regions_with_zero_and_tied_scores_bit_equal_to_jax():
    """A small selection (70 boxes x 40 classes and background) with the
    degenerate inputs chip_smoke.py gives the kernel: flat softmax rows
    (every class ties, and ties with the other flat boxes), scores that
    underflow to exactly 0.0, and zero-width boxes."""
    rng = np.random.default_rng(23)
    boxes, _ = random_boxes(rng, 70)
    boxes[::5, 2] = boxes[::5, 0]
    logits = rng.normal(scale=2.0, size=(70, 41)).astype(np.float32)
    logits[::3] = 0.0
    logits[1::7, 1:15] = -1e4
    scores = np.exp(logits - logits.max(axis=1, keepdims=True))
    scores = (scores / scores.sum(axis=1, keepdims=True)).astype(np.float32)
    assert (scores == 0.0).any()
    want = [np.asarray(x) for x in jnms.select_top_regions(
        jnp.asarray(boxes), jnp.asarray(scores), num_keep=20)]
    got = [x.numpy() for x in pnms.select_top_regions(
        torch.from_numpy(boxes), torch.from_numpy(scores), num_keep=20)]
    names = ("keep_indices", "num_valid", "max_conf", "objects", "cls_prob")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


# ----------------------------------------------------- the launch plan
SERVING_PLANS = [(1600, 300, True), (5, 1000, False)]
EDGE_PLANS = [(64, 1000, True), (40, 2100, True), (3, 2100, False),
              (1, 1, True), (1, 1, False), (7, 64, True), (2, 65, False),
              (100000, 300, True), (1, 8192, True), (65535, 8192, False)]


@pytest.mark.parametrize("G,N,shared", SERVING_PLANS + EDGE_PLANS)
def test_plan_fits_the_card_and_follows_the_shape(G, N, shared):
    """csrc/nms.cu's launch numbers from the shape alone: a power-of-two
    sort at least N long, the walk's shared memory within an H100 block's,
    and for a shared box set one N x ceil(N/64) mask whatever G (up to 512
    boxes beside each group's 2-byte order; above, staged in shared memory
    exactly when it fits beside one group's keys)."""
    plan = pnms.plan_launch(G, N, shared)
    assert plan == pnms.plan_launch(G, N, shared)
    words = -(-N // 64)
    assert plan.words == words and plan.shared == shared
    assert plan.sort_len >= N and plan.sort_len & (plan.sort_len - 1) == 0
    assert 0 < plan.walk_smem <= pnms.SMEM_PER_BLOCK
    assert 8 * plan.sort_len <= pnms.SMEM_PER_BLOCK  # the own-box sort
    mask = 8 * N * words
    assert plan.segments == (shared and plan.sort_len <= 512)
    if plan.segments:  # one mask for every group, then each group's order
        assert plan.staged and plan.groups_per_block == 2
        orders = 2 * 32 * -(-G // 32) * N  # whole blocks of 32 groups
        assert mask <= plan.scratch_bytes - orders < mask + 256
        assert plan.walk_smem == mask + 8 * 32 * words + 2 * 32 * N
        assert plan.kernels == ("nms_sort_kernel",
                                "nms_walk_segments_kernel")
    elif shared:  # one mask for every group, nothing per group
        assert plan.scratch_bytes == mask
        assert 1 <= plan.groups_per_block <= min(G, 8)
        per_group = 8 * (plan.sort_len + 1 + words)
        assert plan.staged == (mask + per_group <= pnms.SMEM_PER_BLOCK)
        assert plan.walk_smem == (mask if plan.staged else 0) + (
            plan.groups_per_block * per_group)
        assert plan.kernels == ("nms_pairs_kernel", "nms_walk_shared_kernel")
    else:
        assert not plan.staged and plan.groups_per_block == 1
        assert plan.scratch_bytes >= 4 * G * N + G * mask
        assert len(plan.kernels) == 3


def test_plan_of_the_serving_calls():
    """The selection makes one 12 KB mask for its 1600 classes, sorts
    them 2 a block and walks them 8 lanes each; the RPN sorts 1024 keys
    per level."""
    sel = pnms.plan_launch(1600, 300, True)
    assert sel.segments and sel.groups_per_block == 2 and sel.sort_len == 512
    assert sel.scratch_bytes == 12032 + 2 * 1600 * 300
    rpn = pnms.plan_launch(5, 1000, False)
    assert rpn.sort_len == 1024 and rpn.words == 16


@pytest.mark.parametrize("G,N,shared", [(1, 0, True), (1, 8193, True),
                                        (1, 8193, False), (0, 10, True),
                                        (65536, 10, False)])
def test_plan_rejects_shapes_the_kernel_does_not_take(G, N, shared):
    with pytest.raises(ValueError):
        pnms.plan_launch(G, N, shared)


# ------------------------------------- chip_smoke.py's IoU count (bound)
def _walk_pairs(boxes, scores, keep, valid):
    """{(group, box, kept box before it)} by a plain loop over the plain
    order."""
    b, s, n_valid, _ = pnms._batched(boxes, scores, valid)
    G, N = s.shape
    n_valid = torch.full((G,), N) if n_valid is None else n_valid
    order = pnms._order(s, n_valid)
    pairs = set()
    for g in range(G):
        kept_before = []
        for i in range(int(n_valid[g])):
            box = int(order[g, i])
            pairs.update((g, box, j) for j in kept_before)
            if keep[g, box]:
                kept_before.append(box)
    return pairs


@pytest.mark.parametrize("valid", [None, [40, 17, 0, 40, 3]])
def test_iou_count_of_a_shared_set_counts_each_pair_once(valid):
    """For boxes shared by every group the bound counts the distinct pairs
    the groups' walks need, at most N(N-1)/2, not one IoU per group."""
    import chip_smoke

    rng = np.random.default_rng(31)
    boxes, _ = random_boxes(rng, 40)
    scores = torch.from_numpy(rng.random((5, 40)).astype(np.float32))
    b = torch.from_numpy(boxes).expand(5, 40, 4)
    keep = pnms.nms_mask_plain(b, scores, 0.5, valid=valid)
    pairs = _walk_pairs(b, scores, keep, valid)
    distinct = {frozenset((i, j)) for _, i, j in pairs}
    got = chip_smoke.nms_iou_count(torch, b, scores, keep, valid)
    assert got == len(distinct) <= 40 * 39 // 2
    assert got < len(pairs)  # groups share IoUs


def test_iou_count_of_own_boxes_is_one_per_walk_step():
    """Own boxes per group: every group's (box, kept box before it) pair
    counts, as before the shared-set change."""
    import chip_smoke

    rng = np.random.default_rng(37)
    boxes = torch.from_numpy(np.stack([random_boxes(rng, 50)[0]
                                       for _ in range(3)]))
    scores = torch.from_numpy(rng.random((3, 50)).astype(np.float32))
    valid = [50, 31, 2]
    keep = pnms.nms_mask_plain(boxes, scores, 0.7, valid=valid)
    got = chip_smoke.nms_iou_count(torch, boxes, scores, keep,
                                   torch.tensor(valid))
    assert got == len(_walk_pairs(boxes, scores, keep, valid)) > 0
