"""One-command real-asset onboarding: convert → boot → smoke → parity.

The port's counterpart of ``vilbert_multitask_tpu/checkpoint/onboard.py``,
with the same flags and the same report. The reference deployment needs
three external assets, none of which ship in either repo: the published
12-in-1 checkpoint ``pytorch_model_9.bin`` (reference worker.py:470), the
real bert-base-uncased WordPiece vocab (worker.py:537-539), and the VQA/GQA
answer-vocabulary pickles (worker.py:299-315). This CLI is the path a
deployer follows when those files are in hand:

    python -m vilbert_multitask_tpu_torch.checkpoint.onboard \
        --torch-bin save/multitask_model/pytorch_model_9.bin \
        --vocab bert-base-uncased-vocab.txt \
        --labels answer_vocabs/ \
        --out onboarded/ \
        --eval vqa=data/vqa_val.jsonl --features feats/ \
        --expect expected_scores.json

Steps, each reported on stderr and in the final JSON report:

1. **convert**  read the torch state dict (checkpoint/convert.py: the
   module tree already has the upstream layout, so keys are checked, not
   renamed) and save it as this package's checkpoint under
   ``<out>/params`` (checkpoint/store.py) for every later boot.
2. **boot**     an ``InferenceEngine`` on the converted params with the
   given vocab/labels (the boot-time vocab-coherence guard runs here: a
   vocab larger than the embedding table fails loudly).
3. **smoke**    one forward per single-image task family on synthetic
   regions: answers must decode out of the *provided* label maps.
4. **parity**   (optional) run the score-parity eval harness on the given
   JSONL/feature data; compare against ``--expect`` scores within
   ``--tol``. Exit 1 on any miss: the report says exactly which.

It runs on the card unless ``--cpu`` is given (then the CPU, f32, dense
attention and the plain kernel versions). tests/test_torch_checkpoint_store.py
rehearses it on a synthetic upstream-layout ``.bin`` with the committed
vocab and labels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _parse_evals(items: List[str]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for it in items:
        if "=" not in it:
            raise SystemExit(f"--eval wants TASK=DATA.jsonl, got {it!r}")
        task, path = it.split("=", 1)
        out[task] = path
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="convert real assets, boot, and rehearse score parity")
    p.add_argument("--torch-bin", required=True,
                   help="published checkpoint, e.g. pytorch_model_9.bin")
    p.add_argument("--vocab", required=True,
                   help="WordPiece vocab file (bert-base-uncased-vocab.txt)")
    p.add_argument("--labels", required=True,
                   help="answer-vocabulary dir (JSON/pickle label maps)")
    p.add_argument("--out", required=True,
                   help="output dir: converted params + report.json")
    p.add_argument("--detector-bin", default=None,
                   help="optional Faster R-CNN torch checkpoint (the "
                        "reference's X-152 detectron weights, worker.py:82-85)"
                        " — converted for --live-extract serving")
    p.add_argument("--eval", action="append", default=[],
                   metavar="TASK=DATA.jsonl",
                   help="run the eval harness on this task/data (repeatable)")
    p.add_argument("--features", default=None,
                   help="precomputed feature dir for --eval")
    p.add_argument("--expect", default=None,
                   help="JSON {task: score} to check parity against")
    p.add_argument("--tol", type=float, default=0.01,
                   help="max |score - expected| accepted (scores are 0-1 "
                        "fractions; 0.01 = one point)")
    p.add_argument("--batch", type=int, default=8)
    from vilbert_multitask_tpu_torch.config import (
        FrameworkConfig,
        add_backend_args,
        apply_backend_args,
        backend_device,
    )

    add_backend_args(p)
    args = p.parse_args(argv)

    # Validate the request shape before any expensive work.
    evals = _parse_evals(args.eval)
    if args.expect and not evals:
        raise SystemExit("--expect without --eval would verify nothing; "
                         "add --eval TASK=DATA.jsonl per expected task")
    if evals and not args.features:
        raise SystemExit("--eval needs --features")

    import dataclasses

    from vilbert_multitask_tpu_torch.checkpoint import (
        load_torch_checkpoint,
        save_params,
    )
    from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine

    cfg = apply_backend_args(FrameworkConfig(), args)
    device = backend_device(args)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, vocab_path=args.vocab, labels_root=args.labels))

    report: Dict = {"torch_bin": args.torch_bin, "steps": {}}

    # 1. convert ------------------------------------------------------------
    t0 = time.perf_counter()
    params = load_torch_checkpoint(args.torch_bin, cfg.model)
    params_dir = os.path.abspath(os.path.join(args.out, "params"))
    save_params(params_dir, params, force=True)  # re-running must work
    report["steps"]["convert"] = {
        "ok": True, "params_dir": params_dir,
        "wall_s": round(time.perf_counter() - t0, 1)}
    _log(f"convert ok → {params_dir}")

    # 1b. detector (optional) ----------------------------------------------
    if args.detector_bin:
        from vilbert_multitask_tpu_torch.config import DetectorConfig
        from vilbert_multitask_tpu_torch.detect.convert import (
            load_torch_detector,
        )
        from vilbert_multitask_tpu_torch.detect.extractor import (
            LiveFeatureExtractor,
        )

        t0 = time.perf_counter()
        dcfg = DetectorConfig().tiny() if args.tiny else DetectorConfig()
        # Same derivation serving uses (serve/app.py): the detector's fc6
        # width IS the trunk's region-feature width — a mismatch here would
        # pass onboarding and crash at the first live-extraction request.
        dcfg = dataclasses.replace(
            dcfg, representation_size=cfg.model.v_feature_size)
        det_params = load_torch_detector(args.detector_bin, dcfg)
        det_dir = os.path.abspath(os.path.join(args.out, "detector_params"))
        save_params(det_dir, det_params, force=True)
        # Smoke the live path the converted weights will serve
        # (serve.app --live-extract): one synthetic image through the full
        # extractor, boxes out.
        import numpy as np

        ex = LiveFeatureExtractor(dcfg, params=det_params, device=device)
        img = (np.random.default_rng(0).random((300, 400, 3)) * 255
               ).astype(np.uint8)
        regions = ex.extract_array(img)
        # extract_array clamps to >=1 box, so n_boxes alone can't flag a
        # degenerate conversion — non-finite features and a feature-width
        # mismatch with the trunk are the real smoke signals.
        if not np.all(np.isfinite(regions.features)):
            raise SystemExit("detector smoke produced non-finite features "
                             "— converted weights are broken")
        if regions.features.shape[1] != cfg.model.v_feature_size:
            raise SystemExit(
                f"detector feature width {regions.features.shape[1]} != "
                f"trunk v_feature_size {cfg.model.v_feature_size}")
        report["steps"]["detector"] = {
            "ok": True, "params_dir": det_dir,
            "n_boxes": int(regions.features.shape[0]),
            "wall_s": round(time.perf_counter() - t0, 1)}
        _log(f"detector convert+smoke ok → {det_dir} "
             f"({regions.features.shape[0]} boxes)")

    # 2. boot ---------------------------------------------------------------
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, params=params, device=device)
    n_vocab = len(engine.tokenizer.vocab)
    report["steps"]["boot"] = {
        "ok": True, "vocab_tokens": n_vocab,
        "embedding_rows": cfg.model.vocab_size,
        "wall_s": round(time.perf_counter() - t0, 1)}
    _log(f"boot ok: vocab {n_vocab} tokens / table "
         f"{cfg.model.vocab_size} rows")

    # 3. smoke --------------------------------------------------------------
    from vilbert_multitask_tpu_torch.features.pipeline import (
        synthetic_regions,
    )

    regions = [synthetic_regions(cfg.model.v_feature_size, n_boxes=36)]
    smoke = {}
    for task_id, q in ((1, "what is the man holding"),
                       (15, "is the bowl right of the mug"),
                       (13, "two dogs play in the snow"),
                       (11, "the woman in the red coat")):
        t0 = time.perf_counter()
        _, result = engine.run(engine.prepare(task_id, q, regions))
        top = (result.answers[0]["answer"] if result.answers
               else f"{len(result.boxes or [])} boxes")
        smoke[task_id] = {"top": top,
                          "ms": round((time.perf_counter() - t0) * 1e3, 1)}
        _log(f"smoke task {task_id}: {top!r} "
             f"({smoke[task_id]['ms']} ms)")
    report["steps"]["smoke"] = {"ok": True, "tasks": smoke}

    # 4. parity -------------------------------------------------------------
    failures: List[str] = []
    if evals:
        from vilbert_multitask_tpu_torch.evals.harness import (
            Evaluator,
            load_jsonl,
        )
        from vilbert_multitask_tpu_torch.features.store import FeatureStore

        engine.feature_store = FeatureStore(args.features)
        expected = {}
        if args.expect:
            with open(args.expect) as f:
                expected = json.load(f)
        ev = Evaluator(engine, batch=args.batch)
        scores: Dict[str, Dict] = {}
        for task, data in evals.items():
            res = ev.run(task, load_jsonl(data))
            scores[task] = res
            # Expected format mirrors the harness output (the committed
            # golden fixture tests/fixtures/golden/scores.json): compare
            # every numeric field the expectation pins (accuracy, R@1, …).
            exp = expected.get(task)
            if exp is None:
                _log(f"eval {task}: {res}")
                continue
            if not isinstance(exp, dict):
                exp = {"accuracy": exp}  # plain-number shorthand
            for key, want in exp.items():
                if not isinstance(want, (int, float)) or key == "task_id":
                    continue
                got = res.get(key)
                delta = (abs(float(got) - float(want))
                         if got is not None else float("inf"))
                ok = delta <= args.tol
                _log(f"eval {task}.{key}: {got} vs expected {want} "
                     f"(|Δ|={delta:.4f} tol={args.tol}) "
                     + ("PASS" if ok else "FAIL"))
                if not ok:
                    failures.append(
                        f"{task}.{key}: {got} != {want} ±{args.tol}")
        # "Exit 0 = every expected score reproduced": an expectation with
        # no corresponding --eval was never measured — that's a failure,
        # not a silent pass.
        for task in sorted(set(expected) - set(evals)):
            failures.append(
                f"{task}: expected but never evaluated "
                f"(add --eval {task}=DATA.jsonl)")
        report["steps"]["parity"] = {
            "ok": not failures, "scores": scores,
            "expected": expected, "failures": failures}

    report["ok"] = not failures
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    if failures:
        _log(f"PARITY FAILED: {failures}")
        return 1
    _log("onboarding complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
