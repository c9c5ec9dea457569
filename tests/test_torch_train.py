"""The port's losses, optimizer and train step held against the JAX
package's ``train/`` on the same seeded inputs and weights.

Tolerances. Every loss casts its inputs to float32 before any reduction on
both sides (``_f32``, losses.py:33), even under x64, so the losses and the
first gradient of the backward pass are f32 computations whatever the
trunk's dtype; the two libraries' f32 log-softmax, log1p and sums differ in
the last bits:

- losses: rtol 1e-6 (f32 and f64 inputs alike, measured up to ~2e-7);
- a step with the trunk in f64: the f32 loss gradients (relative ~1e-7)
  carried through an f64 backward. Gradients and moments rtol 1e-5 against
  each leaf's scale, the grad norm rtol 1e-6; parameters atol 1e-6 at a
  learning rate of 1e-3, where Adam's normalised update (~1 per element)
  leaves the rounding of the smallest gradient elements at most a few
  percent of one update;
- a step with the trunk in f32: an f32 backward on top, whose roundings
  add up over the layers and cancel in the attention weights' gradients:
  the moments rtol 1e-4 against each leaf's scale (measured 3.7e-5 at
  most); the parameters: at most 0.1% of the elements beyond 1e-6 and
  none beyond a tenth of the rate per step (measured: 2 of ~60,000
  elements, 2.6e-5 at most at a rate of 1e-3: elements whose small
  gradient the f32 rounding moves, normalised by Adam); the rest as in
  f64.
- The parameters whose gradient is zero but for rounding (a softmax is
  invariant to them: :func:`_zero_gradient`) are held as that function
  says.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_port_helpers as H
from vilbert_multitask_tpu.models.vilbert import ViLBertForVLTasks
from vilbert_multitask_tpu.models.vilbert import ViLBertOutput as JaxOutput
from vilbert_multitask_tpu.train import losses as jl
from vilbert_multitask_tpu.train import step as js
from vilbert_multitask_tpu_torch.checkpoint.convert import from_flax_params
from vilbert_multitask_tpu_torch.models.vilbert import (
    ViLBertOutput as PortOutput,
)
from vilbert_multitask_tpu_torch.ops.coattention import flash_cross_attention
from vilbert_multitask_tpu_torch.train import losses as pl
from vilbert_multitask_tpu_torch.train import step as ps
from vilbert_multitask_tpu_torch.train.convert import TIED, from_jax_train_state

LOSS_RTOL = 1e-6
B, NT, NV = 4, 12, 9
ALL_HEADS = ("vqa", "gqa", "binary", "tri", "grounding", "retrieval", "mlm",
             "mrm")
STEP_OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=50)


# ------------------------------------------------------------------ losses
def _head_outputs(cfg, seed=0):
    """Seeded logits of every head (numpy) and the targets the losses read."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (3 * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    out = dict(vil_prediction=f(B, cfg.num_labels),
               vil_prediction_gqa=f(B, cfg.gqa_num_labels),
               vil_logit=f(B, 1), vil_binary_prediction=f(B // 2, 2),
               vil_tri_prediction=f(B, 3),
               vision_prediction=f(B, NV, cfg.v_target_size),
               vision_logit=f(B, NV, 1),
               linguisic_prediction=f(B, NT + 1, cfg.vocab_size),
               linguisic_logit=f(B, NT + 1, 1))
    image_mask = np.ones((B, NV), np.int32)
    image_mask[:, -2:] = 0
    batch = dict(
        vqa_target=(rng.random((B, cfg.num_labels)) < 0.2).astype(np.float32)
        * rng.random((B, cfg.num_labels)).astype(np.float32),
        gqa_target=rng.random((B, cfg.gqa_num_labels)).astype(np.float32),
        binary_label=rng.integers(0, 2, (B // 2,)).astype(np.int32),
        tri_label=rng.integers(0, 3, (B,)).astype(np.int32),
        grounding_target=rng.random((B, NV)).astype(np.float32),
        image_mask=image_mask,
        mlm_labels=np.where(rng.random((B, NT)) < 0.3,
                            rng.integers(0, cfg.vocab_size, (B, NT)),
                            -1).astype(np.int32),
        mrm_target=rng.random((B, NV, cfg.v_target_size)).astype(np.float32),
        mrm_mask=(rng.random((B, NV)) < 0.4).astype(np.float32),
    )
    return out, batch


def _jax_outputs(out, dtype):
    return JaxOutput(**{k: jnp.asarray(v, dtype) for k, v in out.items()},
                     attn_data_list=[])


def _port_outputs(out, dtype):
    return PortOutput(**{k: torch.from_numpy(v).to(dtype)
                         for k, v in out.items()}, attn_data_list=[])


def _single_losses(o, b, group):
    """(name, callable over (module, outputs, batch)) of every loss."""
    return {
        "label_bce_loss": lambda L, o, b: L.label_bce_loss(
            o.vil_prediction, b["vqa_target"]),
        "softmax_ce_loss": lambda L, o, b: L.softmax_ce_loss(
            o.vil_tri_prediction, b["tri_label"]),
        "grounding_loss": lambda L, o, b: L.grounding_loss(
            o.vision_logit, b["grounding_target"], b["image_mask"]),
        "retrieval_contrastive_loss": lambda L, o, b:
            L.retrieval_contrastive_loss(o.vil_logit, group),
        "masked_lm_loss": lambda L, o, b: L.masked_lm_loss(
            o.linguisic_prediction, b["mlm_labels"]),
        "masked_lm_loss_aligned": lambda L, o, b: L.masked_lm_loss(
            o.linguisic_prediction[:, 1:], b["mlm_labels"]),
        "masked_region_loss": lambda L, o, b: L.masked_region_loss(
            o.vision_prediction, b["mrm_target"], b["mrm_mask"]),
    }


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(_single_losses(None, None, 2)))
def test_each_loss_matches_jax(tiny_config, name, f64):
    out, batch = _head_outputs(tiny_config)
    fn = _single_losses(None, None, 2)[name]
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        want = fn(jl, _jax_outputs(out, jdt),
                  {k: jnp.asarray(v) for k, v in batch.items()})
        assert want.dtype == jnp.float32  # _f32 even under x64
        want = float(want)
    got = fn(pl, _port_outputs(out, torch.float64 if f64 else torch.float32),
             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_sigmoid_bce_elementwise_matches_jax():
    rng = np.random.default_rng(3)
    x = (10 * rng.normal(size=(64,))).astype(np.float32)
    t = rng.random(64).astype(np.float32)
    want = np.asarray(jl.optax_sigmoid_bce(jnp.asarray(x), jnp.asarray(t)))
    got = pl.optax_sigmoid_bce(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_multitask_loss_over_every_head_matches_jax(tiny_config, f64):
    out, batch = _head_outputs(tiny_config, seed=1)
    weights = (1.0, 0.5, 2.0, 1.0, 0.25, 1.0, 3.0, 1.5)
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        jt, jm = jl.multitask_loss(
            jl.LossConfig(heads=ALL_HEADS, weights=weights,
                          retrieval_group_size=2),
            _jax_outputs(out, jdt),
            {k: jnp.asarray(v) for k, v in batch.items()})
        jm = {k: float(v) for k, v in jm.items()}
    pt, pm = pl.multitask_loss(
        pl.LossConfig(heads=ALL_HEADS, weights=weights,
                      retrieval_group_size=2),
        _port_outputs(out, torch.float64 if f64 else torch.float32),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(pm) == set(jm) and len(pm) == 9
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), jm[k], rtol=LOSS_RTOL,
                                   err_msg=k)
    assert float(pt) == pytest.approx(jm["loss/total"], rel=LOSS_RTOL)
    with pytest.raises(ValueError, match="unknown loss head"):
        pl.multitask_loss(pl.LossConfig(heads=("nope",)),
                          _port_outputs(out, torch.float32), {})


# --------------------------------------------------- schedule, clip, mask
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("warmup,total", [(1, 50), (5, 50), (10, 10)])
def test_schedule_matches_optax(warmup, total, f64):
    tx = ps.default_optimizer(learning_rate=1e-3, warmup_steps=warmup,
                              total_steps=total)
    dtype = torch.float64 if f64 else torch.float32
    with jax.enable_x64(f64):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, warmup, max(total, warmup + 1))
        want = [float(sched(jnp.asarray(c, jnp.int32)))
                for c in range(total + 5)]
    got = [tx.schedule(c, dtype) for c in range(total + 5)]
    assert got[0] == want[0] == 0.0
    # optax's joined schedule returns float32 values under x64 too, and the
    # two libraries' f32 cos may differ in the last bit: 1 ulp of f32 of
    # the peak rate (near the end of the decay 1 + cos(x) cancels, so the
    # bit counts against the peak, not against the small value).
    np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=1.2e-7 * 1e-3)


@pytest.mark.parametrize("values,clipped", [
    ([0.5, 0.0, 0.0], False),  # below the limit: untouched
    ([1.0, 0.0, 0.0], False),  # exactly at it: not < 1, scaled by 1/1
    ([3.0, 4.0, 0.0], True),  # norm 5
    ([1e-3, 2e-3, 7.0], True),
])
def test_clip_by_global_norm_matches_optax(values, clipped):
    rng = np.random.default_rng(4)
    extra = (0.0 if not clipped else 1.0) * rng.normal(size=(5, 3)).astype(
        np.float32)
    tree = {"a": np.asarray(values, np.float32), "b": extra}
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in tree.items()}, None)
    got, norm = ps.clip_by_global_norm(
        [torch.from_numpy(tree["a"]), torch.from_numpy(tree["b"])], 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in tree.items()})), rtol=1e-7)
    for g, k in zip(got, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)
    if not clipped:
        np.testing.assert_array_equal(got[0].numpy(), tree["a"])


def test_global_norm_of_a_large_leaf_is_exact():
    """The global norm of leaves of millions of elements (the full-width
    word embeddings hold 23 M) is their f64 norm rounded to f32: torch's
    f32 norm on the CPU sums in f32 and reads such a leaf low."""
    rng = np.random.default_rng(6)
    big = (rng.normal(size=4_000_000) * 1e-3 + 2e-4).astype(np.float32)
    small = rng.normal(size=10).astype(np.float32)
    want = np.sqrt(np.sum(big.astype(np.float64) ** 2)
                   + np.sum(small.astype(np.float64) ** 2))
    _, norm = ps.clip_by_global_norm(
        [torch.from_numpy(big), torch.from_numpy(small)], 1e9)
    assert norm.dtype == torch.float32
    np.testing.assert_allclose(float(norm), want, rtol=1.2e-7)


def test_weight_decay_mask_matches_jax(tiny_config):
    params = H.seeded_params(tiny_config)
    mask = js._weight_decay_mask(params)
    # The mask as arrays of the leaves' shapes, through the parameters' own
    # name map (transposes and the qkv split).
    as_arrays = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), m), params, mask)
    want = from_flax_params(as_arrays, H.to_port_config(tiny_config))
    model = H.port_model(tiny_config, params)
    named = dict(model.named_parameters())
    assert set(named) == set(want) - {TIED}
    decayed = {k for k, p in named.items() if ps.is_decayed(k, p)}
    assert decayed == {k for k in named if want[k].all()}
    assert not any(want[k].any() and not want[k].all() for k in named)
    # Linear and Embedding weights are decayed, LayerNorm weights not.
    assert "bert.embeddings.word_embeddings.weight" in decayed
    assert "bert.embeddings.LayerNorm.weight" not in decayed


# ----------------------------------------------------------------- a step
class _Deterministic:
    """The Flax model with dropout off: the JAX step passes
    ``deterministic=False`` (step.py:118), and its two dropout streams have
    no counterpart here."""

    def __init__(self, model):
        self.model = model

    def apply(self, variables, *args, deterministic=False, rngs=None, **kw):
        return self.model.apply(variables, *args, deterministic=True, **kw)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    image_mask = np.ones((B, NV), np.int32)
    image_mask[:, -2:] = 0
    input_mask = np.ones((B, NT), np.int32)
    input_mask[:, -3:] = 0
    return dict(
        input_ids=rng.integers(0, cfg.vocab_size, (B, NT)).astype(np.int32),
        features=rng.normal(size=(B, NV, cfg.v_feature_size)).astype(
            np.float32),
        spatials=rng.random((B, NV, 5)).astype(np.float32),
        segment_ids=np.zeros((B, NT), np.int32),
        input_mask=input_mask,
        image_mask=image_mask,
        task_ids=np.ones((B, 1), np.int32),
        vqa_target=(rng.random((B, cfg.num_labels)) < 0.1).astype(np.float32),
        gqa_target=rng.random((B, cfg.gqa_num_labels)).astype(np.float32),
        tri_label=rng.integers(0, 3, (B,)).astype(np.int32),
        binary_label=rng.integers(0, 2, (B // 2,)).astype(np.int32),
        grounding_target=rng.random((B, NV)).astype(np.float32),
        mlm_labels=np.where(rng.random((B, NT)) < 0.3,
                            rng.integers(0, cfg.vocab_size, (B, NT)),
                            -1).astype(np.int32),
        mrm_target=rng.random((B, NV, cfg.v_target_size)).astype(np.float32),
        mrm_mask=(rng.random((B, NV)) < 0.3).astype(np.float32),
    )


def _adam(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return adam


def _jax_run(cfg, params, batch, steps, f64):
    """JAX's make_train_step (dropout off) for ``steps`` steps: a list of
    (params, mu, nu, grad_norm) numpy snapshots after each step."""
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        model = _Deterministic(ViLBertForVLTasks(cfg, dtype=jdt))
        tx = js.default_optimizer(**STEP_OPT)
        step = js.make_train_step(
            model, tx, jl.LossConfig(heads=ALL_HEADS), donate=False)
        tree = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), params)
        state = js.create_train_state(tree, tx)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        snaps = []
        for _ in range(steps):
            state, metrics = step(state, jb)
            adam = _adam(state.opt_state)
            snaps.append(jax.device_get((state.params, adam.mu, adam.nu,
                                         metrics["grad_norm"],
                                         metrics["loss/total"])))
    return snaps


def _port_setup(cfg, params, f64):
    dtype = torch.float64 if f64 else torch.float32
    model = H.port_model(cfg, params, dtype=dtype, pallas=False)  # eval mode
    tx = ps.default_optimizer(**STEP_OPT)
    state = ps.create_train_state(model, tx)
    step = ps.make_train_step(model, tx, pl.LossConfig(heads=ALL_HEADS))
    return model, state, step


def _zero_gradient(name: str) -> bool:
    """The attention key biases, and ``vil_logit.bias`` under the
    contrastive loss: a softmax is invariant to them, so their gradient is
    zero but for rounding (f32 rounding even in an f64 trunk: the loss
    gradient is f32), and each library rounds its own way. Their moments
    are held to rounding of the largest moment, and Adam normalises the
    noise into updates of up to the learning rate, so the parameters are
    held to the rate per step."""
    return name.endswith(("key.bias", "key1.bias", "key2.bias",
                          "vil_logit.bias"))


def _assert_state_close(pcfg, state, snap, f64, grad_norm=None):
    params, mu, nu, jnorm, _ = snap
    rel = 1e-5 if f64 else 1e-4
    far = total = 0
    for what, tree, tol in (("params", params, None), ("mu", mu, rel),
                            ("nu", nu, rel)):
        want = from_flax_params(jax.tree_util.tree_map(np.asarray, tree),
                                pcfg)
        got = getattr(state, what)
        # A leaf is held relative to its own scale, floored at 1e-4 of the
        # largest leaf's.
        top = max(float(np.abs(want[k]).max()) for k in got)
        for k, t in got.items():
            w = want[k]
            g = t.detach().numpy()
            if tol is None and not f64 and not _zero_gradient(k):
                # f32: an element whose gradient is near its layer's
                # rounding is normalised by Adam like any other, so a few
                # elements move by a share of the rate.
                diff = np.abs(g - w)
                far += int((diff > 1e-6).sum())
                total += diff.size
                atol = 0.1 * STEP_OPT["learning_rate"] * state.step
            elif tol is None:
                atol = (STEP_OPT["learning_rate"] * state.step
                        if _zero_gradient(k) else 1e-6)
            elif _zero_gradient(k):
                atol = 1e-6 * top
            else:
                atol = tol * max(float(np.abs(w).max()), 1e-4 * top)
            np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                       err_msg=f"{what} {k}")
    assert far <= 1e-3 * max(total, 1), (far, total)
    if grad_norm is not None:
        np.testing.assert_allclose(float(grad_norm), float(jnorm), rtol=1e-6)


@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
def test_steps_match_jax(tiny_config, f64):
    """One step, then three, dropout off: parameters, both moments and the
    grad norm against the JAX step over all eight loss heads."""
    params = H.seeded_params(tiny_config)
    batch = _batch(tiny_config)
    snaps = _jax_run(tiny_config, params, batch, 3, f64)
    pcfg = H.to_port_config(tiny_config)
    _, state, step = _port_setup(tiny_config, params, f64)
    moved = 0.0
    for i in range(3):
        before = {k: v.detach().clone() for k, v in state.params.items()}
        state, metrics = step(state, batch)
        assert state.step == i + 1
        np.testing.assert_allclose(float(metrics["loss/total"]),
                                   float(snaps[i][4]), rtol=1e-5)
        _assert_state_close(pcfg, state, snaps[i], f64,
                            grad_norm=metrics["grad_norm"])
        moved = max(moved, max(float((state.params[k].detach() - before[k]).abs()
                                     .max()) for k in before))
    # The first step's rate is 0 (warmup from 0); later steps move the
    # parameters by about the learning rate.
    assert moved > 5e-4


def test_jax_state_carried_across_continues_as_jax(tiny_config):
    """Two JAX steps, the state carried across with from_jax_train_state,
    the third on the port: as JAX's third step."""
    params = H.seeded_params(tiny_config)
    batch = _batch(tiny_config, seed=2)
    snaps = _jax_run(tiny_config, params, batch, 3, False)
    pcfg = H.to_port_config(tiny_config)
    p2, mu2, nu2, _, _ = snaps[1]
    host = from_jax_train_state(2, p2, mu2, nu2, pcfg)
    _, state, step = _port_setup(tiny_config, params, False)
    ps.load_train_state(state, host)
    assert state.step == 2
    _assert_state_close(pcfg, state, snaps[1], False)
    state, metrics = step(state, batch)
    _assert_state_close(pcfg, state, snaps[2], False,
                        grad_norm=metrics["grad_norm"])


def test_load_train_state_rejects_other_keys(tiny_config):
    params = H.seeded_params(tiny_config)
    _, state, _ = _port_setup(tiny_config, params, False)
    host = ps.TrainState(step=1, params={"x": torch.zeros(1)}, mu={}, nu={})
    with pytest.raises(KeyError, match="missing"):
        ps.load_train_state(state, host)


# ------------------------------------------------------------------ remat
def _loss_and_grads(model, batch, heads=("vqa", "tri")):
    loss_cfg = pl.LossConfig(heads=heads)
    b = ps.batch_tensors(batch, torch.device("cpu"))
    out = model(*(b[k] for k in ps.MODEL_INPUTS), None, b["task_ids"])
    loss, _ = pl.multitask_loss(loss_cfg, out, b)
    model.zero_grad(set_to_none=True)
    loss.backward()
    return float(loss), {k: p.grad.clone() for k, p in
                         model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("dropout", [False, True], ids=["eval", "dropout"])
def test_remat_matches_plain_gradients(tiny_config, dropout):
    """cfg.remat changes memory and FLOPs, never values: the same loss and
    gradients (the JAX test's tolerances), dropout on included: the
    recompute must replay the trainer's generator, which
    torch.utils.checkpoint does not restore by itself."""
    from vilbert_multitask_tpu_torch.models.layers import (
        set_dropout_generator,
    )

    params = H.seeded_params(tiny_config)
    batch = _batch(tiny_config)
    plain = H.port_model(tiny_config, params, pallas=False)
    remat = H.port_model(dataclasses.replace(tiny_config, remat=True),
                         params, pallas=False)
    assert remat.config.remat
    results = []
    for model in (plain, remat):
        if dropout:
            model.train()
            set_dropout_generator(model, torch.Generator().manual_seed(7))
        results.append(_loss_and_grads(model, batch))
    (l0, g0), (l1, g1) = results
    np.testing.assert_allclose(l0, l1, rtol=1e-6)
    assert set(g0) == set(g1)
    for k in g0:
        np.testing.assert_allclose(g1[k].numpy(), g0[k].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    if dropout:  # the masks were drawn: another seed gives another loss
        set_dropout_generator(plain, torch.Generator().manual_seed(8))
        assert _loss_and_grads(plain, batch)[0] != l0


def test_dropout_replays_from_the_generator_state(tiny_config):
    """The same generator state gives the same masks (what a resumed run
    relies on); dropout off is the identity."""
    from vilbert_multitask_tpu_torch.ops.attention import dropout

    x = torch.ones(4, 1000)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    a = dropout(x, 0.1, True, g)
    g.set_state(state)
    b = dropout(x, 0.1, True, g)
    assert torch.equal(a, b)
    assert 0.05 < float((a == 0).float().mean()) < 0.15
    assert torch.allclose(a[a != 0], torch.tensor(1 / 0.9))
    assert dropout(x, 0.1, False, g) is x


def test_dropout_without_a_generator_draws_from_the_default():
    """No generator: the mask comes from torch's default generator, the
    same seed giving the same mask, in x's dtype."""
    from vilbert_multitask_tpu_torch.ops.attention import dropout

    x = torch.ones(4, 1000, dtype=torch.bfloat16)
    torch.manual_seed(5)
    a = dropout(x, 0.1, True)
    torch.manual_seed(5)
    assert torch.equal(a, dropout(x, 0.1, True))
    assert a.dtype == torch.bfloat16
    assert 0.05 < float((a == 0).float().mean()) < 0.15
    assert torch.equal(a[a != 0],
                       torch.full_like(a[a != 0], 1 / 0.9))


# ------------------------------------------- the kernel has no backward
def test_flash_attention_refuses_a_lost_gradient():
    # The wrapper's route on meta tensors (no card here): a gradient it
    # would lose raises before anything else; a call with none gets past
    # that gate to the device check
    q = torch.zeros(1, 3, 1, 8, requires_grad=True, device="meta")
    k = v = torch.zeros(1, 3, 1, 8, device="meta")
    bias = torch.zeros(1, 1, 1, 3, device="meta")
    with pytest.raises(RuntimeError, match="no backward"):
        flash_cross_attention(q, k, v, bias)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_cross_attention(k, q, v, bias)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        flash_cross_attention(q, k, v, bias)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="CUDA tensors"):
        flash_cross_attention(torch.zeros(1, 3, 1, 8, device="meta"), k, v,
                              bias)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_cross_attention(q.detach(), k, v, bias)


def test_train_state_aliases_the_tied_decoder(tiny_config):
    params = H.seeded_params(tiny_config)
    model, state, _ = _port_setup(tiny_config, params, False)
    assert state.aliases == {TIED: "bert.embeddings.word_embeddings.weight"}
    sd = state.state_dict()
    assert set(sd) == set(model.state_dict())
    assert sd[TIED] is state.params["bert.embeddings.word_embeddings.weight"]
