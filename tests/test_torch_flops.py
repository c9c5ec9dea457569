"""The port's serving roofline (``vilbert_multitask_tpu_torch/engine/
flops.py``) against the JAX package's (``vilbert_multitask_tpu/engine/
flops.py``).

- ``serving_forward_flops`` is the JAX integer for ``ViLBertConfig()`` and
  its tiny form at buckets 1, 10 and 32;
- ``param_tree_bytes`` and ``weight_bytes_per_row`` agree with the JAX
  functions on the same bf16 and int8 trees;
- ``knee_rows`` and ``serving_roofline`` at the H100's name are the JAX
  formulas evaluated at its datasheet rates (989.4e12 FLOP/s dense bf16,
  3.35e12 B/s), and a CPU's kind states the H100 reference;
- the estimate lies within the JAX test's band (tests/test_bench_flops.py:
  at most 1.02x and at least 0.6x) of what ``FlopCounterMode`` counts
  over the port's tiny serving forward at batches 1 and 3, with the dense
  attention and with the kernel route (its plain version here), which
  count the same.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from vilbert_multitask_tpu import quant as jquant
from vilbert_multitask_tpu.config import EngineConfig as JaxEngineConfig
from vilbert_multitask_tpu.config import ViLBertConfig as JaxViLBertConfig
from vilbert_multitask_tpu.engine import flops as jflops
from vilbert_multitask_tpu.engine.runtime import InferenceEngine as JaxEngine
from vilbert_multitask_tpu.config import FrameworkConfig as JaxFramework
from vilbert_multitask_tpu_torch.config import (
    EngineConfig,
    FrameworkConfig,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine import flops
from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

H100 = "NVIDIA H100 80GB HBM3"
PEAK, BW = 989.4e12, 3.35e12


def _port(jcfg):
    return ViLBertConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("width", ["full", "tiny"])
@pytest.mark.parametrize("batch", [1, 10, 32])
def test_serving_forward_flops_is_the_jax_integer(width, batch):
    jcfg = JaxViLBertConfig()
    jcfg = jcfg.tiny() if width == "tiny" else jcfg
    got = flops.serving_forward_flops(_port(jcfg), EngineConfig(), batch)
    assert got == jflops.serving_forward_flops(jcfg, JaxEngineConfig(), batch)
    assert isinstance(got, int)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_param_bytes_agree_with_jax_on_the_same_tree(dtype):
    jcfg = JaxFramework(model=JaxViLBertConfig().tiny(),
                        engine=JaxEngineConfig(compute_dtype="float32",
                                               max_regions=11))
    params = jax.device_get(JaxEngine(jcfg, seed=0).params)
    tree = (jquant.quantize_tree(params) if dtype == "int8" else
            jax.tree_util.tree_map(lambda x: np.asarray(x, jnp.bfloat16),
                                   params))
    want = jflops.param_tree_bytes(tree)
    assert flops.param_tree_bytes(jax.device_get(tree)) == want
    for batch in (1, 8, 32):
        assert flops.weight_bytes_per_row(want, batch) == \
            jflops.weight_bytes_per_row(want, batch)


def test_roofline_at_the_h100_is_the_jax_formula(monkeypatch):
    """The JAX functions with their rate tables given the H100's entry
    compute what the port's do at that name."""
    monkeypatch.setattr(jflops, "PEAK_BF16_FLOPS", (("h100 80gb hbm3", PEAK),))
    monkeypatch.setattr(jflops, "PEAK_HBM_BYTES_PER_S",
                        (("h100 80gb hbm3", BW),))
    assert flops.peak_flops_for(H100) == PEAK
    assert flops.peak_hbm_bw_for(H100) == BW
    for width in ("full", "tiny"):
        jcfg = JaxViLBertConfig()
        jcfg = jcfg.tiny() if width == "tiny" else jcfg
        for param_bytes in (637_100_000, 283_200_000, 12345):
            assert flops.knee_rows(_port(jcfg), EngineConfig(), H100,
                                   param_bytes) == jflops.knee_rows(
                jcfg, JaxEngineConfig(), H100, param_bytes)
            for batch in (1, 8, 32):
                assert flops.serving_roofline(
                    _port(jcfg), EngineConfig(), batch, H100,
                    param_bytes) == jflops.serving_roofline(
                    jcfg, JaxEngineConfig(), batch, H100, param_bytes)


def test_unknown_kinds_state_the_h100_reference():
    assert flops.peak_flops_for("cpu") is None
    assert flops.peak_hbm_bw_for("cpu") is None
    mcfg = ViLBertConfig()
    cpu = flops.serving_roofline(mcfg, EngineConfig(), 1, "cpu", 600_000_000)
    card = flops.serving_roofline(mcfg, EngineConfig(), 1, H100, 600_000_000)
    assert cpu["achievable_mfu"] == card["achievable_mfu"]
    assert "H100" in cpu["reason"] and "'cpu'" in cpu["reason"]
    assert flops.knee_rows(mcfg, EngineConfig(), "cpu", 600_000_000) == \
        flops.knee_rows(mcfg, EngineConfig(), H100, 600_000_000)


@pytest.mark.parametrize("kernel_route", [False, True])
@pytest.mark.parametrize("batch", [1, 3])
def test_estimate_vs_flop_counter_over_the_port_forward(kernel_route, batch):
    cfg = FrameworkConfig(model=ViLBertConfig().tiny(), engine=EngineConfig(
        compute_dtype="float32", max_regions=11,
        use_pallas_coattention=kernel_route,
        use_pallas_self_attention=kernel_route))
    eng = InferenceEngine(cfg, device="cpu")
    eng._row_slab()
    nt = cfg.engine.max_text_len
    pack = torch.zeros((batch, 3 * nt + 2), dtype=torch.long)
    pack[:, 2 * nt:3 * nt] = 1  # text mask; slot 0, the pad row
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        eng._rows_step(pack)
    counted = counter.get_total_flops()
    est = flops.serving_forward_flops(cfg.model, cfg.engine, batch)
    assert est <= counted * 1.02, (est, counted)
    assert est >= 0.6 * counted, (est, counted)
