"""Seeded weights, made on the device in a few large draws.

One ``torch.Generator`` on the device per model, seeded from the run's seed,
draws every random leaf in one call, in the type the leaf is served in
(the trunk's matrices, tables and biases in bfloat16, the detector in
float32); each leaf is a scaled view of that draw. The program and the
reference are handed the same dict.

Recipes: the trunk's Linear weights N(0, 1/fan_in), biases N(0, 0.02²),
embedding rows N(0, 1/dim), LayerNorm 1 and 0. The detector's convolution
and Linear weights lecun-normal truncated at 2σ, biases 0, frozen
BatchNorm scale 1 and bias 0 except the stem's scale 1/64 and every
block's last scale 0.2, so that 50 residual blocks and unit-less pixels
leave the RPN sigmoids and the class softmax unsaturated.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import detector as ref_det
from portbench.reference import vilbert as ref_vil

_TRUNK, _DETECTOR = 1, 2


def stream_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of a run (weights, traffic, sample),
    from the run's seed."""
    return int(np.random.SeedSequence([int(seed), purpose])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def _draw(shapes, seed: int, device, dtype) -> torch.Tensor:
    total = sum(int(np.prod(s)) for s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(total, generator=gen, device=device, dtype=dtype)


def trunk_weights(d: ref_vil.Dims, seed: int, device,
                  dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The served trunk's state dict in upstream keys, the MLM decoder tied
    to the word table as the upstream model ties it."""
    leaves = list(ref_vil.param_shapes(d))
    drawn = [(k, s, kind) for k, s, kind in leaves
             if kind in ("linear", "bias", "table")]
    flat = _draw([s for _, s, _ in drawn], stream_seed(seed, _TRUNK),
                 device, dtype)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape, kind in drawn:
        n = int(np.prod(shape))
        leaf = flat[at:at + n].view(shape)
        at += n
        scale = {"linear": shape[-1] ** -0.5, "bias": 0.02,
                 "table": shape[-1] ** -0.5}[kind]
        sd[key] = leaf.mul_(scale)
    for key, shape, kind in leaves:
        if kind == "ln_weight":
            sd[key] = torch.ones(shape, device=device)
        elif kind in ("ln_bias", "zeros"):
            sd[key] = torch.zeros(shape, device=device)
    sd["cls.predictions.decoder.weight"] = sd[
        "bert.embeddings.word_embeddings.weight"]
    return sd


def detector_weights(d: ref_det.DetDims, seed: int, device
                     ) -> Dict[str, torch.Tensor]:
    """The extractor's state dict (float32) in its own keys."""
    leaves = list(ref_det.param_shapes(d))
    drawn = [(k, s) for k, s, kind in leaves if kind in ("conv", "linear")]
    flat = _draw([s for _, s in drawn], stream_seed(seed, _DETECTOR),
                 device, torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in drawn:
        n = int(np.prod(shape))
        fan_in = n // shape[0]
        std = fan_in ** -0.5 / 0.87962566103423978
        sd[key] = flat[at:at + n].view(shape).clamp_(-2, 2).mul_(std)
        at += n
    for key, shape, kind in leaves:
        if kind == "bias" or kind == "bn_bias":
            sd[key] = torch.zeros(shape, device=device)
        elif kind == "bn_scale":
            value = 1.0
            if key == "backbone.stem_bn.scale":
                value = 1.0 / 64.0
            elif key.endswith(".bn3.scale"):
                value = 0.2
            sd[key] = torch.full(shape, value, device=device)
    return sd
