"""Whether what the timed path produced is right: the plain reference works
every sampled answer out again from the seed's weights and the same raw
inputs (gallery files, upload bytes, question text), and the served
answers are judged against it.

Per answer (each family's head: the VQA or GQA labels, NLVR2's pair,
SNLI-VE's three classes, a retrieval's candidates, a grounding's 101
regions), with the reference's logits ``L`` over the family's choices, for
each of the served bundle's first three entries (its k-th choice ``j_k``
with its confidence):

- ``answer_gap``: ``|sorted(L)[k] - L[j_k]|``, how far the reference's
  logit of the served k-th choice lies from the reference's own k-th
  largest (0 when both rank the same), the largest over the sample;
- ``answer_logp_err``: ``|ln p_served(j_k) - log_softmax(L)[j_k]|``, the
  error of the served confidence of that choice in log-probability, the
  largest over the sample; ``answer_logp_mean`` its mean over every entry
  judged (``answer_flips`` counts the answers whose first choice differs,
  and is not compared).

Per upload (the extractor's regions, against the reference detector run on
the same file), the largest over the sample:

- ``region_feat_err``: the largest gap between a served region's fc6
  features and the reference's features pooled at the same box from its
  own feature maps, over that row's largest reference value;
- ``region_miss``: the share of served boxes with no reference box at
  IoU >= 0.99.

The configuration file's ``limits`` names the numbers compared, each with
its limit. With a control, the answers judged are the control's: the
reference computed in fp8, answering the same requests over the
regions the program served.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from portbench.reference import detector as ref_det
from portbench.reference import inputs as ref_in
from portbench.reference import vilbert as ref_vil

NLVR2 = ("False", "True")
SNLI_VE = ("contradiction (false)", "neutral", "entailment (true)")
LABEL_HEADS = {1: ("vil_prediction", "vqa"), 2: ("vil_prediction", "vqa"),
               15: ("vil_prediction_gqa", "gqa")}
GROUNDING = (4, 11, 16)


@dataclasses.dataclass
class Sample:
    """One served request kept for the comparison."""

    task_id: int
    text: str
    images: List[str]  # gallery files, or the one upload file
    result: Any  # the served answer (the program's decoded result)
    upload: bool = False
    regions: Any = None  # an upload's served regions


TOP = 3  # the served entries compared: the UI's top-3 bundle


def _choice_index(names, value: str) -> Optional[int]:
    """The served answer's index among the choices (None when it is none
    of them)."""
    if value in names:
        return names.index(value)
    if value.startswith("<") and value.endswith(">"):
        return int(value[1:-1])
    return None


def served_entries(sample: Sample, logits: Dict[str, torch.Tensor],
                   labels: Dict[str, list]) -> tuple:
    """The reference's logits over the family's choices, and the served
    entries in their served order as (choice index, confidence)."""
    res, t = sample.result, sample.task_id
    if t in LABEL_HEADS:
        head, names = LABEL_HEADS[t]
        return logits[head][0], [
            (_choice_index(labels[names], a["answer"]), a["confidence"])
            for a in res.answers]
    if t in (12, 13):
        head, names = (("vil_binary_prediction", NLVR2) if t == 12
                       else ("vil_tri_prediction", SNLI_VE))
        return logits[head][0], [(_choice_index(names, a["answer"]),
                                  a["confidence"]) for a in res.answers]
    if t == 7:
        L = logits["vil_logit"][:len(sample.images)]
        free = list(range(len(sample.images)))
        out = []
        for entry in res.ranking:
            # a candidate image may repeat: take its best unclaimed row
            rows = ([i for i in free if sample.images[i] == entry["image"]]
                    or [i for i, p in enumerate(sample.images)
                        if p == entry["image"]])
            j = max(rows, key=lambda i: float(L[i])) if rows else None
            if j in free:
                free.remove(j)
            out.append((j, entry["confidence"]))
        return L, out
    if t in GROUNDING:
        return logits["vision_logit"][0], [
            (int(b["region_index"]), b["confidence"]) for b in res.boxes]
    raise ValueError(f"no comparison for task {t}")


def answer_numbers(sample: Sample, logits: Dict[str, torch.Tensor],
                   labels: Dict[str, list]) -> List[tuple]:
    """(gap, log-probability error) of each of the served answer's first
    ``TOP`` entries against the reference's logits for its rows: the gap
    between the reference's logit of the served k-th choice and the
    reference's own k-th largest logit, and the error of the served
    confidence in log-probability."""
    L, entries = served_entries(sample, logits, labels)
    L = L.double()
    ranked = torch.sort(L, descending=True).values
    logp = torch.log_softmax(L, dim=-1)
    out = []
    for k, (j, conf) in enumerate(entries[:TOP]):
        if j is None or not 0 <= j < len(L) or k >= len(L):
            out.append((math.inf, math.inf))  # no choice of the family
            continue
        gap = abs(float(ranked[k] - L[j]))
        err = abs(float(np.log(max(conf, 1e-300))) - float(logp[j]))
        out.append((gap, err))
    return out


def region_numbers(w, d: ref_det.DetDims, served, ref: ref_det.Regions
                   ) -> tuple:
    """(feature error, miss share) of one upload's served regions."""
    boxes = np.asarray(served.boxes, np.float32)
    feats = np.asarray(served.features, np.float32)
    want = ref_det.pooled_features(w, d, ref, boxes)
    scale = np.maximum(np.abs(want).max(axis=1), 1e-6)
    feat_err = float((np.abs(feats - want).max(axis=1) / scale).max())
    iou = ref_det.box_iou(torch.from_numpy(boxes),
                          torch.from_numpy(np.asarray(ref.boxes, np.float32)))
    miss = float((iou.max(dim=1).values < 0.99).float().mean())
    return feat_err, miss


class Reference:
    """The plain reference on the run's device, built after the program's
    state is freed: the seed's trunk weights in float32 (and the detector's
    for uploads)."""

    def __init__(self, config: dict, seed: int, device, *,
                 detector: bool = False, control: bool = False):
        from portbench import weights

        self.device = device
        self.dims = ref_vil.Dims.from_config(config["model"])
        sd = weights.trunk_weights(self.dims, seed, device)
        self.w = ref_vil.reference_weights(sd, self.dims)
        # The control: the reference in fp8 compute put in the program's
        # place, answering the same requests over the served regions.
        self.control_w = (ref_vil.reference_weights(sd, self.dims,
                                                    compute="fp8")
                          if control else None)
        del sd
        self.tok = ref_in.tokenizer()
        self.labels = {"vqa": ref_in.label_names("vqa"),
                       "gqa": ref_in.label_names("gqa")}
        self.det_dims = self.det_w = None
        if detector:
            self.det_dims = ref_det.DetDims.from_config(config["detector"])
            self.det_w = weights.detector_weights(self.det_dims, seed, device)
        self.max_text_len = int(config["engine"]["max_text_len"])
        self.max_regions = int(config["engine"]["max_regions"])

    def logits(self, task_id: int, text: str, regions: List[dict],
               w=None) -> Dict[str, torch.Tensor]:
        """The reference's head logits for one request's rows (its text
        repeated over its images)."""
        enc = ref_in.encode_text(self.tok, text, task_id, self.max_text_len)
        rows = [dict(enc, task_ids=np.int64(task_id),
                     **ref_in.encode_regions(r["features"], r["boxes"],
                                             r["width"], r["height"],
                                             self.max_regions))
                for r in regions]
        batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                 for k, v in ref_in.stack_rows(rows).items()}
        with torch.no_grad():
            return {k: v.cpu() for k, v in
                    ref_vil.forward(w or self.w, self.dims,
                                    batch).items()}

    def judge(self, samples: List[Sample]) -> Dict[str, float]:
        """The largest of each number over ``samples``."""
        from PIL import Image

        worst: Dict[str, float] = {"answer_gap": 0.0, "answer_logp_err": 0.0}
        if any(s.upload for s in samples):
            worst.update(region_feat_err=0.0, region_miss=0.0)
        errs, flips = [], 0
        with torch.no_grad(), _f32():
            for s in samples:
                if s.upload:
                    rgb = np.asarray(Image.open(s.images[0]).convert("RGB"))
                    reg = ref_det.extract(self.det_w, self.det_dims, rgb,
                                          self.device)
                    fe, miss = region_numbers(self.det_w, self.det_dims,
                                              s.regions, reg)
                    worst["region_feat_err"] = max(worst["region_feat_err"],
                                                   fe)
                    worst["region_miss"] = max(worst["region_miss"], miss)
                    regions = [{"features": reg.features, "boxes": reg.boxes,
                                "width": reg.width, "height": reg.height}]
                    served = [{"features": s.regions.features,
                               "boxes": s.regions.boxes,
                               "width": s.regions.image_width,
                               "height": s.regions.image_height}]
                else:
                    from portbench.traffic import read_gallery_file

                    regions = served = [read_gallery_file(p)
                                        for p in s.images]
                if self.control_w is not None:
                    s = dataclasses.replace(s, result=decoded(
                        s, self.logits(s.task_id, s.text, served,
                                       self.control_w), self.labels))
                entries = answer_numbers(
                    s, self.logits(s.task_id, s.text, regions), self.labels)
                for gap, err in entries:
                    worst["answer_gap"] = max(worst["answer_gap"], gap)
                    worst["answer_logp_err"] = max(worst["answer_logp_err"],
                                                   err)
                    errs.append(err)
                flips += entries[0][0] > 0
        worst["answer_logp_mean"] = float(np.mean(errs)) if errs else 0.0
        worst["answer_flips"] = float(flips)
        return worst


def decoded(sample: Sample, logits: Dict[str, torch.Tensor],
            labels: Dict[str, list]):
    """The served bundle of each family from ``logits`` (the first ``TOP``
    choices with their confidences, both of NLVR2's, every retrieval
    candidate ranked), in the fields :func:`served_entries` reads."""
    from types import SimpleNamespace

    t = sample.task_id

    def ranked(L, k=None):
        p = torch.softmax(L.double(), dim=-1)
        order = torch.argsort(L, descending=True)[:k]
        return [(int(j), float(p[j])) for j in order]

    if t in LABEL_HEADS:
        head, names = LABEL_HEADS[t]
        names = labels[names]
        return SimpleNamespace(answers=[
            {"answer": names[j] if j < len(names) else f"<{j}>",
             "confidence": p} for j, p in ranked(logits[head][0], TOP)])
    if t in (12, 13):
        L = logits["vil_binary_prediction" if t == 12
                   else "vil_tri_prediction"][0]
        names = NLVR2 if t == 12 else SNLI_VE
        return SimpleNamespace(answers=[
            {"answer": names[j], "confidence": p} for j, p in ranked(L)])
    if t == 7:
        return SimpleNamespace(ranking=[
            {"image": sample.images[j], "confidence": p}
            for j, p in ranked(logits["vil_logit"][:len(sample.images)])])
    return SimpleNamespace(boxes=[
        {"region_index": j, "confidence": p}
        for j, p in ranked(logits["vision_logit"][0], TOP)])


class _f32:
    """TF32 off for the reference's matmuls and convolutions."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def pick(rng: np.random.Generator, candidates: List[Sample], k: int,
         longest: Optional[Sample] = None) -> List[Sample]:
    """``k`` samples drawn by the seed, with the longest request in."""
    idx = rng.permutation(len(candidates))[:k]
    out = [candidates[i] for i in sorted(idx)]
    if longest is not None and all(s is not longest for s in out):
        out.append(longest)
    return out
