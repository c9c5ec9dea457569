"""The residual-add LayerNorm's plain version against flax, its wrapper's
checks, its route, and its wiring into the served forward, on the CPU.

``ops/layer_norm.py:add_layer_norm_plain`` is held against what the JAX
package computes at each site: flax ``nn.LayerNorm(dtype=dt)`` over ``h +
r`` (both in dt: the JAX code adds two arrays of the compute dtype), the
heads' ``fused_layer_norm`` with a ``(2, W)`` scale over ``(B, 2, W)``,
and flax with bf16 parameters (the int8 engine's dequantized tree). The
inputs are seeded numpy arrays handed to both. Tolerances are the kernels'
own (PERF.md §2): f32 within 2e-5·max(1, |ref|) (summation order only),
bf16 within atol 1e-2 + rtol 1e-2 (one bf16 rounding of the output; in
practice at most one ulp apart).

The kernel itself runs only on the card: chip_smoke.py holds it against
this plain version at the served shapes.
"""

from __future__ import annotations


import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_port_helpers as H
from vilbert_multitask_tpu_torch.engine.graphs import launches_per_forward
from vilbert_multitask_tpu.models.heads import (
    fused_layer_norm as jax_fused_layer_norm,
)
from vilbert_multitask_tpu_torch.ops import layer_norm as ln_ops
from vilbert_multitask_tpu_torch.ops import routes

EPS = 1e-12
F32_TOL = 2e-5
BF16_ATOL = BF16_RTOL = 1e-2
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _close(got: np.ndarray, want: np.ndarray, dtype: str) -> None:
    got, want = got.astype(np.float64), want.astype(np.float64)
    if dtype == "float32":
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= F32_TOL, err.max()
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def _inputs(rows, width, seed, groups=None):
    """h, r and parameters: N(0, 1) rows with a per-row offset and scale (a
    post-attention stream is neither centred nor unit), γ near 1, β near 0."""
    rng = np.random.default_rng(seed)
    lead = (rows,) if groups is None else (rows, groups)
    h = (rng.normal(size=lead + (width,)) * rng.uniform(0.5, 4, lead + (1,))
         + rng.normal(size=lead + (1,))).astype(np.float32)
    r = rng.normal(size=lead + (width,)).astype(np.float32)
    pshape = (width,) if groups is None else (groups, width)
    w = (1 + 0.1 * rng.normal(size=pshape)).astype(np.float32)
    b = (0.1 * rng.normal(size=pshape)).astype(np.float32)
    return h, r, w, b


def _flax(x, w, b, dtype):
    """flax nn.LayerNorm(dtype=...) with parameters ``w``, ``b`` (already in
    the parameter dtype)."""
    return np.asarray(fnn.LayerNorm(epsilon=EPS, dtype=dtype).apply(
        {"params": {"scale": w, "bias": b}}, x).astype(jnp.float32))


@pytest.mark.parametrize("width", [768, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("params", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "alone"])
def test_plain_matches_flax_layer_norm(width, dtype, params, residual):
    tdt, jdt = DTYPES[dtype]
    ptdt, pjdt = DTYPES[params]
    h, r, w, b = _inputs(38, width, seed=width + len(dtype))
    jh, jr = jnp.asarray(h).astype(jdt), jnp.asarray(r).astype(jdt)
    jw, jb = jnp.asarray(w).astype(pjdt), jnp.asarray(b).astype(pjdt)
    want = _flax(jh + jr if residual else jh, jw, jb, jdt)
    th = torch.from_numpy(h).to(tdt)
    tr = torch.from_numpy(r).to(tdt) if residual else None
    got = ln_ops.add_layer_norm_plain(
        th, tr, torch.from_numpy(w).to(ptdt), torch.from_numpy(b).to(ptdt),
        EPS)
    assert got.dtype == tdt and got.shape == th.shape
    _close(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [64, 2048])
def test_grouped_parameters_match_the_fused_label_head(dtype, width):
    """The label pair's (B, 2, W) with a (2, W) scale: row i takes group
    i % 2, as the JAX heads' fused_layer_norm and, per head, flax."""
    tdt, jdt = DTYPES[dtype]
    h, _, w, b = _inputs(3, width, seed=7, groups=2)
    jh = jnp.asarray(h).astype(jdt)
    want = np.asarray(jax_fused_layer_norm(jh, jnp.asarray(w), jnp.asarray(b),
                                           EPS).astype(jnp.float32))
    per_head = np.stack([_flax(jh[:, g], jnp.asarray(w[g]), jnp.asarray(b[g]),
                               jdt) for g in range(2)], 1)
    got = ln_ops.add_layer_norm_plain(torch.from_numpy(h).to(tdt), None,
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), EPS)
    _close(got.float().numpy(), want, dtype)
    _close(got.float().numpy(), per_head, dtype)


def test_autocast_pair_matches_the_module_composition():
    """The trainer's autocast forward adds a bf16 Linear output to an f32
    residual: the sum and the output are f32 (JAX promotes the same way),
    and the plain version is flax over that f32 sum."""
    h, r, w, b = _inputs(38, 768, seed=3)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    mixed = jh + jnp.asarray(r)
    assert mixed.dtype == jnp.float32
    want = _flax(mixed, jnp.asarray(w), jnp.asarray(b), jnp.float32)
    th = torch.from_numpy(h).to(torch.bfloat16)
    got = ln_ops.add_layer_norm_plain(th, torch.from_numpy(r),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b), EPS)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "float32")
    # The composition the trunk ran before (sum, F.layer_norm) agrees too.
    before = F.layer_norm(th + torch.from_numpy(r), (768,),
                          torch.from_numpy(w), torch.from_numpy(b), EPS)
    _close(got.numpy(), before.numpy(), "float32")


def test_f64_keeps_f64_statistics():
    h, r, w, b = _inputs(5, 48, seed=11)
    got = ln_ops.add_layer_norm_plain(
        torch.from_numpy(h).double(), torch.from_numpy(r).double(),
        torch.from_numpy(w).double(), torch.from_numpy(b).double(), EPS)
    with jax.enable_x64(True):
        want = np.asarray(fnn.LayerNorm(epsilon=EPS, dtype=jnp.float64).apply(
            {"params": {"scale": jnp.asarray(w, jnp.float64),
                        "bias": jnp.asarray(b, jnp.float64)}},
            jnp.asarray(h, jnp.float64) + jnp.asarray(r, jnp.float64)))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_gradients_match_flax():
    """A recorded call takes F.layer_norm (the kernel has no backward): its
    gradients against jax.grad of flax in f32 (two-pass against fast
    variance: f32 rounding apart)."""
    h, r, w, b = _inputs(6, 64, seed=5)
    g = np.random.default_rng(9).normal(size=h.shape).astype(np.float32)

    def jax_loss(h, r, w, b):
        y = fnn.LayerNorm(epsilon=EPS).apply(
            {"params": {"scale": w, "bias": b}}, h + r)
        return (y * g).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (h, r, w, b)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (h, r, w, b)]
    y = ln_ops.layer_norm(*leaves, EPS)
    assert y.grad_fn is not None
    (y * torch.from_numpy(g)).sum().backward()
    for t, jg in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------------- the wrapper
def test_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    h, r, w, b = (torch.from_numpy(a) for a in _inputs(4, 32, seed=1))
    before = ln_ops.add_layer_norm.launches
    got = ln_ops.add_layer_norm(h, r, w, b, EPS)
    assert torch.equal(got, ln_ops.add_layer_norm_plain(h, r, w, b, EPS))
    assert ln_ops.add_layer_norm.launches == before


def _launch_case(case: str):
    h, r, w, b = (torch.from_numpy(a) for a in _inputs(4, 32, seed=2))
    bf = torch.bfloat16
    return {
        "bf16_bf16": (h.to(bf), r.to(bf), w, b),
        "bf16_f32_autocast_pair": (h.to(bf), r, w, b),
        "f32_f32": (h, r, w, b),
        "bf16_alone_bf16_params": (h.to(bf), None, w.to(bf), b.to(bf)),
        "f32_alone": (h, None, w, b),
        "grouped": (h, None, torch.stack([w, w]), torch.stack([b, b])),
        # rejected
        "f32_bf16_pair": (h, r.to(bf), w, b),
        "f16": (h.half(), None, w, b),
        "f64": (h.double(), r.double(), w, b),
        "params_f64": (h, r, w.double(), b.double()),
        "params_mixed": (h, r, w, b.to(bf)),
        "width_12": (h[:, :12].contiguous(), None, w[:12].contiguous(),
                     b[:12].contiguous()),
        "width_36": (torch.zeros(4, 36), None, torch.ones(36),
                     torch.zeros(36)),
        "strided_rows": (torch.zeros(4, 64)[:, ::2], None, w, b),
        "offset_8_bytes": (torch.zeros(4 * 32 + 2)[2:].view(4, 32), None, w,
                           b),
    }[case]


@pytest.mark.parametrize("case", ["bf16_bf16", "bf16_f32_autocast_pair",
                                  "f32_f32", "bf16_alone_bf16_params",
                                  "f32_alone", "grouped"])
def test_launch_check_accepts_what_the_kernel_reads(case):
    ln_ops._check_launchable(*_launch_case(case))


@pytest.mark.parametrize("case,error", [
    ("f32_bf16_pair", TypeError), ("f16", TypeError), ("f64", TypeError),
    ("params_f64", TypeError), ("params_mixed", TypeError),
    ("width_12", ValueError), ("width_36", ValueError),
    ("strided_rows", ValueError), ("offset_8_bytes", ValueError)])
def test_launch_check_rejects_what_the_kernel_cannot_read(case, error):
    with pytest.raises(error):
        ln_ops._check_launchable(*_launch_case(case))


@pytest.mark.parametrize("bad", ["residual_shape", "param_width",
                                 "groups_do_not_divide", "devices"])
def test_wrapper_rejects_bad_shapes(bad):
    h, r, w, b = (torch.from_numpy(a) for a in _inputs(3, 32, seed=4))
    args = {"residual_shape": (h, r[:2], w, b),
            "param_width": (h, r, w[:16], b[:16]),
            "groups_do_not_divide": (h, None, torch.stack([w, w]),
                                     torch.stack([b, b])),
            "devices": (h, r.to("meta"), w, b)}[bad]
    with pytest.raises(ValueError):
        ln_ops.add_layer_norm(*args, EPS)


def test_a_lost_gradient_is_refused():
    """The wrappers refuse an input that needs a gradient (on the card; on
    the CPU they take the plain version), and the route never hands them
    one."""
    x = torch.zeros(2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        routes.refuse_gradient("add_layer_norm", torch.zeros(2, 8), x)
    with torch.no_grad():
        routes.refuse_gradient("add_layer_norm", x)
        assert not routes.records_gradient(x)
    routes.refuse_gradient("add_layer_norm", x.detach(), None)
    assert routes.records_gradient(None, x)


# ------------------------------------------------------ the forward's sites
# The row kernels' entry points (H.spy_row_kernels counts their calls).
ENTRY_POINTS = ("add_layer_norm", "scaled_masked_softmax", "dense_attention")
_spies = H.spy_row_kernels


def forward_launches(mcfg, rows: int, **kw) -> dict:
    """The entry points' share of engine/graphs.py:launches_per_forward
    (what chip_smoke.py expects on the card)."""
    want = launches_per_forward(mcfg, rows, **kw)
    return {k: want[k] for k in ENTRY_POINTS}


def test_the_full_serving_config_counts():
    """What chip_smoke.py reads on the card at full width: bucket 1 runs
    the 18 flash launches, 63 LayerNorms (no NLVR2 head on one row) and
    the 12 text layers' dense cores, no softmax; two rows add the NLVR2
    head's LayerNorm; collected maps move the bridges to the softmax; an
    f32 engine's text layers take the softmax."""
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        ViLBertConfig,
    )

    full = ViLBertConfig()
    assert launches_per_forward(full, 1) == {
        "flash_attn": 18, "add_layer_norm": 63, "scaled_masked_softmax": 0,
        "dense_attention": 12}
    assert launches_per_forward(full, 2)["add_layer_norm"] == 64
    assert launches_per_forward(full, 1, collect_attention=True) == {
        "flash_attn": 6, "add_layer_norm": 63, "scaled_masked_softmax": 12,
        "dense_attention": 12}
    f32 = launches_per_forward(full, 1,
                               ecfg=EngineConfig(compute_dtype="float32"))
    assert (f32["dense_attention"], f32["scaled_masked_softmax"]) == (0, 12)
    # Text longer than 128 tokens keeps the composition.
    long_text = launches_per_forward(full, 1,
                                     ecfg=EngineConfig(max_text_len=128))
    assert (long_text["dense_attention"],
            long_text["scaled_masked_softmax"]) == (0, 12)


@pytest.fixture(scope="module")
def tiny_engine(tmp_path_factory):
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        FrameworkConfig,
        ViLBertConfig,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.features.store import FeatureStore

    root = tmp_path_factory.mktemp("ln_wiring")
    mcfg = ViLBertConfig().tiny()
    H.write_feature_files(str(root), mcfg.v_feature_size,
                          ["img_a", "img_b"])
    cfg = FrameworkConfig(model=mcfg, engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8,
        image_buckets=(1, 2), throughput_buckets=None))
    return InferenceEngine(cfg, params=init_state_dict(mcfg, seed=0),
                           feature_store=FeatureStore(str(root)),
                           device="cpu")


@pytest.mark.parametrize("task_id,images,collect", [
    (1, ["img_a"], False), (12, ["img_a", "img_b"], False),
    (1, ["img_a"], True)], ids=["bucket1", "bucket2_nlvr2", "bucket1_maps"])
def test_the_served_forward_calls_each_entry_point_per_site(
        tiny_engine, monkeypatch, task_id, images, collect):
    calls = _spies(monkeypatch)
    req = tiny_engine.prepare_from_store(task_id, "what is here", images)
    tiny_engine.run(req, collect_attention=collect)
    assert calls == forward_launches(tiny_engine.model_config, req.bucket,
                                     collect_attention=collect,
                                     ecfg=tiny_engine.cfg.engine)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_the_int8_forward_takes_the_same_routes(tmp_path, monkeypatch, int8):
    """RoundedLayerNorm passes its bf16 parameter copies to the same entry
    point: the int8 engine calls it as often as the float one."""
    from vilbert_multitask_tpu_torch.config import (
        EngineConfig,
        FrameworkConfig,
        ViLBertConfig,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import (
        InferenceEngine,
        init_state_dict,
    )
    from vilbert_multitask_tpu_torch.features.store import FeatureStore

    mcfg = ViLBertConfig().tiny()
    H.write_feature_files(str(tmp_path), mcfg.v_feature_size, ["img_a"])
    cfg = FrameworkConfig(model=mcfg, engine=EngineConfig(
        max_text_len=12, max_regions=9, num_features=8, image_buckets=(1,),
        throughput_buckets=None,
        param_dtype="int8" if int8 else "float32"))
    eng = InferenceEngine(cfg, params=init_state_dict(mcfg, seed=0),
                          feature_store=FeatureStore(str(tmp_path)),
                          device="cpu")
    calls = _spies(monkeypatch)
    eng.run(eng.prepare_from_store(1, "what is here", ["img_a"]))
    assert calls == forward_launches(mcfg, 1, ecfg=cfg.engine)


def _pre_port_layer_norm(self, x, residual=None):
    """The trunk's LayerNorm module before the kernel: the sum,
    F.layer_norm (two-pass variance) at promote(dtype, f32), the cast
    back."""
    s = x if residual is None else x + residual
    dt = torch.promote_types(s.dtype, torch.float32)
    return F.layer_norm(s.to(dt), self.normalized_shape, self.weight.to(dt),
                        self.bias.to(dt), self.eps).to(s.dtype)


def test_a_training_step_calls_neither_kernel_and_keeps_its_gradients(
        tiny_config, monkeypatch):
    """A grad-recording forward routes every site away from the kernels'
    entry points, to the composition the trunk ran before them
    (F.layer_norm, the softmax chain): the gradients of a step are the
    same bits."""
    from vilbert_multitask_tpu_torch.models.layers import LayerNorm
    from vilbert_multitask_tpu_torch.train import losses as pl
    from vilbert_multitask_tpu_torch.train import step as ps

    params = H.seeded_params(tiny_config)
    rng = np.random.default_rng(0)
    b, nt, nv = 4, 9, 7
    i32, f32 = np.int32, np.float32
    batch = dict(
        input_ids=rng.integers(0, tiny_config.vocab_size, (b, nt)).astype(i32),
        features=rng.normal(size=(b, nv, tiny_config.v_feature_size)).astype(
            f32),
        spatials=rng.random((b, nv, 5)).astype(f32),
        segment_ids=np.zeros((b, nt), i32), input_mask=np.ones((b, nt), i32),
        image_mask=np.ones((b, nv), i32), task_ids=np.ones((b, 1), i32),
        vqa_target=(rng.random((b, tiny_config.num_labels)) < 0.2).astype(
            f32),
        tri_label=rng.integers(0, 3, (b,)).astype(i32))
    batch["input_mask"][:, -2:] = 0
    batch["image_mask"][:, -1] = 0

    def grads():
        # eval mode: dropout off; the parameters require grad.
        model = H.port_model(tiny_config, params, pallas=False)
        t = ps.batch_tensors(batch, torch.device("cpu"))
        out = model(*(t[k] for k in ps.MODEL_INPUTS), None, t["task_ids"])
        loss, _ = pl.multitask_loss(pl.LossConfig(heads=("vqa", "tri")),
                                    out, t)
        loss.backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()
                if p.grad is not None}

    calls = _spies(monkeypatch)
    now = grads()
    assert calls == dict.fromkeys(ENTRY_POINTS, 0)
    monkeypatch.setattr(LayerNorm, "forward", _pre_port_layer_norm)
    before = grads()
    assert set(now) == set(before) and len(now) > 50
    for k in now:
        assert torch.equal(now[k], before[k]), k


def test_int8_head_slabs_keep_the_layer_norm_leaves_f32():
    """The JAX int8 engine keeps the heads' LayerNorm scales and biases
    floating at full precision (engine/runtime.py:_make_head_slab_builder):
    the port's int8 slabs hold them in f32 too (only the dense biases go to
    the compute dtype), which the LayerNorm kernel takes as one pair."""
    from vilbert_multitask_tpu_torch import quant
    from vilbert_multitask_tpu_torch.config import ViLBertConfig
    from vilbert_multitask_tpu_torch.engine.runtime import init_state_dict
    from vilbert_multitask_tpu_torch.models.heads import (
        build_int8_head_slabs,
    )

    mcfg = ViLBertConfig().tiny()
    sd = init_state_dict(mcfg, seed=0)
    tree = quant.quantize_tree(sd)
    slabs = build_int8_head_slabs(tree, mcfg, torch.bfloat16, "cpu")
    for name in ("label_ln_scale", "label_ln_bias", "binary_ln_scale",
                 "binary_ln_bias"):
        assert slabs[name].dtype == torch.float32, name
    assert torch.equal(slabs["binary_ln_bias"],
                       sd["vil_binary_prediction.logit_fc.2.bias"])
    assert slabs["label_d1_bias"].dtype == torch.bfloat16
