"""Offline kernel-library cache population:
``python -m vilbert_multitask_tpu_torch.engine.prewarm``.

Counterpart of ``vilbert_multitask_tpu/engine/prewarm.py``. Builds, into
the cache directory a server boots from (``EngineConfig.aot_cache_dir``,
engine/aotcache.py), every kernel library the chosen variant launches:
nvcc on a miss; on a hit the library is loaded. Either way each kernel is
then launched once at a small shape on the card and held against its plain
PyTorch version, so a cache that is reported warm is one that runs. Run it
after a change to a kernel, the flags or the toolkit, and every host that
mounts the directory boots with no nvcc run:

    python -m vilbert_multitask_tpu_torch.engine.prewarm \\
        --cache-dir <dir> [--dtype float32|bfloat16|int8] [--live-extract]

One process covers one variant, whose libraries ``ops/routes.py:LIBRARIES``
declares (``--dtype int8`` adds the ``int8`` variant's, ``--live-extract``
the detector's). It prints one JSON report (each library: ``hit`` or
``built``, nvcc's seconds, the verification's error and the fingerprint)
and exits non-zero without nvcc, without a card, or when a build or a
check fails: it never skips.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# f32 kernel against its plain version: |d| <= TOL * max(1, |ref|) (the
# repo's f32 kernel tolerance).
TOL = 2e-5
# The bf16-only dense_attention against its plain version on the same bf16
# inputs: the output rounded to bf16 (2^-8 relative) and a score that
# rounds the other way when the two sum in another order.
BF16_TOL = 2e-2


def _check_flash_attn(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.ops.coattention import (
        flash_cross_attention,
        flash_cross_attention_plain,
    )

    q, k, v = (torch.randn(1, n, 2, 128, generator=gen).to(dev)
               for n in (38, 101, 101))
    bias = torch.zeros(1, 1, 1, 101, device=dev)
    bias[..., 90:] = -10000.0
    ref = flash_cross_attention_plain(q, k, v, bias)
    return _err(flash_cross_attention(q, k, v, bias), ref)


def _check_int8_linear(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.ops.int8_linear import (
        int8_linear,
        int8_linear_plain,
    )

    x = torch.randn(38, 64, generator=gen).to(dev)
    q = torch.randint(-127, 128, (96, 64), generator=gen,
                      dtype=torch.int8).to(dev)
    scale = (torch.rand(96, generator=gen) * 0.01).to(dev)
    bias = torch.randn(96, generator=gen).to(dev)
    return _err(int8_linear(x, q, scale, bias),
                int8_linear_plain(x, q, scale, bias))


def _check_nms(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.ops.nms import nms_mask, nms_mask_plain

    xy = torch.rand(3, 200, 2, generator=gen) * 300
    wh = torch.rand(3, 200, 2, generator=gen) * 80 + 4
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    scores = torch.rand(3, 200, generator=gen).to(dev)
    keep = nms_mask(boxes, scores, 0.5)
    return float((keep != nms_mask_plain(boxes, scores, 0.5)).sum())


def _check_roi_align(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.detect.model import (
        roi_align,
        roi_align_plain,
    )

    strides = (4.0, 8.0, 16.0, 32.0)
    feats = [torch.randn(128 // int(s), 128 // int(s), 32,
                         generator=gen).to(dev) for s in strides]
    xy = torch.rand(20, 2, generator=gen) * 64
    boxes = torch.cat([xy, xy + torch.rand(20, 2, generator=gen) * 60 + 2],
                      -1).to(dev)
    return _err(roi_align(feats, boxes, strides, 7, 2),
                roi_align_plain(feats, boxes, strides, 7, 2))


def _check_grouped_conv(torch, dev, gen) -> float:
    """The bottleneck middle at 64 channels in 4 groups, stride 1 and 2,
    against its composition on cuDNN in full f32."""
    from vilbert_multitask_tpu_torch.ops.grouped_conv import (
        grouped_conv_bn_relu_plain,
        launch,
    )

    c, err = 64, 0.0
    args = [torch.randn(1, c, 30, 33, generator=gen),
            torch.randn(c, 16, 3, 3, generator=gen) / 12,
            1 + 0.1 * torch.randn(c, generator=gen),
            0.5 * torch.randn(c, generator=gen),
            1 + 0.1 * torch.randn(c, generator=gen),
            0.5 * torch.randn(c, generator=gen)]
    args = [a.to(dev) for a in args]
    for stride in (1, 2):
        kw = dict(stride=stride, padding=1, groups=4)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            ref = grouped_conv_bn_relu_plain(*args, **kw)
        err = max(err, _err(launch(*args, **kw), ref))
    return err


def _check_layer_norm(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.ops.layer_norm import (
        add_layer_norm,
        add_layer_norm_plain,
    )

    h, r = (torch.randn(38, 768, generator=gen).to(dev) for _ in range(2))
    w = (1 + 0.1 * torch.randn(768, generator=gen)).to(dev)
    b = (0.1 * torch.randn(768, generator=gen)).to(dev)
    return _err(add_layer_norm(h, r, w, b, 1e-12),
                add_layer_norm_plain(h, r, w, b, 1e-12))


def _check_softmax(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.ops.softmax import (
        scaled_masked_softmax,
        scaled_masked_softmax_plain,
    )

    s = torch.randn(1, 12, 38, 38, generator=gen).to(dev) * 8
    bias = torch.zeros(1, 1, 1, 38, device=dev)
    bias[..., 30:] = -10000.0
    return _err(scaled_masked_softmax(s, bias, 0.125),
                scaled_masked_softmax_plain(s, bias, 0.125))


def _check_dense_attention(torch, dev, gen) -> float:
    from vilbert_multitask_tpu_torch.ops.dense_attention import (
        dense_attention,
        dense_attention_plain,
    )

    q, k, v = (torch.randn(1, 38, 12, 64, generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    bias = torch.zeros(1, 1, 1, 38, device=dev, dtype=torch.bfloat16)
    bias[..., 30:] = -10000.0
    return _err(dense_attention(q, k, v, bias, 0.125),
                dense_attention_plain(q, k, v, bias, 0.125))


def _err(got, ref) -> float:
    """The largest |got - ref| / max(1, |ref|)."""
    return float(((got.float() - ref.float()).abs()
                  / ref.float().abs().clamp_min(1.0)).max())


CHECKS = {"flash_attn": _check_flash_attn,
          "layer_norm": _check_layer_norm, "softmax": _check_softmax,
          "dense_attention": _check_dense_attention,
          "int8_linear": _check_int8_linear,
          "nms": _check_nms, "roi_align": _check_roi_align,
          "grouped_conv": _check_grouped_conv}


def _declared(variant: str) -> str:
    from vilbert_multitask_tpu_torch.ops.routes import LIBRARIES

    return ", ".join(lib.name for lib in LIBRARIES if lib.variant == variant)


def main(argv=None) -> int:
    from vilbert_multitask_tpu_torch.config import FrameworkConfig

    p = argparse.ArgumentParser(
        description="build the kernel libraries a server variant launches "
                    "into its cache directory (offline; hosts that mount "
                    "it then boot with no nvcc run), and check each on the "
                    "card")
    p.add_argument("--cache-dir", default=None,
                   help="library cache root (default: EngineConfig."
                        "aot_cache_dir, else serve_state/aot_cache)")
    p.add_argument("--dtype", default=None,
                   choices=("float32", "bfloat16", "int8"),
                   help="prewarm this param-storage variant instead of the "
                        "config default (int8 adds %s)" % _declared("int8"))
    p.add_argument("--live-extract", action="store_true",
                   help="the live-extraction variant (adds the detector's "
                        "%s)" % _declared("live_extract"))
    args = p.parse_args(argv)

    import torch

    from vilbert_multitask_tpu_torch import _build
    from vilbert_multitask_tpu_torch.engine import aotcache

    cfg = FrameworkConfig()
    ecfg = cfg.engine
    cache_dir = (args.cache_dir or ecfg.aot_cache_dir
                 or os.path.join("serve_state", "aot_cache"))
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        ecfg, aot_cache_dir=cache_dir,
        **({"param_dtype": args.dtype} if args.dtype else {})))
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        print(f"prewarm: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("prewarm: no CUDA device (torch.cuda.is_available() is "
              "False); the libraries are checked on the card", file=sys.stderr)
        return 2
    fingerprint = aotcache.compile_fingerprint(
        cfg, live_extract=args.live_extract)
    cache = aotcache.AotCache(cache_dir, fingerprint)
    t0 = time.perf_counter()
    cache.prefetch()
    built = cache.join()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    report = {"cache_dir": cache.root, "fingerprint": fingerprint,
              "param_dtype": cfg.engine.param_dtype,
              "live_extract": args.live_extract, "libraries": {}}
    failed = []
    for name, rec in built["libraries"].items():
        err = CHECKS[name](torch, dev, gen)
        torch.cuda.synchronize()
        ok = err == 0 if name == "nms" else err <= (
            BF16_TOL if name == "dense_attention" else TOL)
        report["libraries"][name] = {
            "status": rec["status"], "seconds": rec["seconds"],
            "load_s": rec["load_s"], "file": os.path.basename(rec["path"]),
            "max_err": err, "ok": ok}
        if not ok:
            failed.append(name)
    report.update(misses=built["misses"], compile_s=built["compile_s"],
                  total_s=time.perf_counter() - t0,
                  device=torch.cuda.get_device_name(0))
    print(json.dumps(report, indent=1))
    if failed:
        print(f"prewarm: {failed} disagree with their plain versions",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
