"""Serving runtime: bucketed ViLBERT inference on one CUDA device.

Counterpart of ``vilbert_multitask_tpu/engine/runtime.py`` — the engine
facade the serve tier calls: :meth:`InferenceEngine.prepare` /
:meth:`~InferenceEngine.prepare_from_store` (WordPiece tokenization, region
encode, bucketing), :meth:`~InferenceEngine.run` (the trunk forward, the
fused heads and the on-device softmax/top-3 bundle), :meth:`~InferenceEngine.
decode` (host numpy) and :meth:`~InferenceEngine.predict`.

- **Device.** The engine runs on ``cuda`` unless the caller passes
  ``device="cpu"`` (the tests do); asking for CUDA where there is none
  raises instead of carrying on on the CPU. On the CPU every kernel wrapper
  takes its plain PyTorch version.
- **Kernels.** The engine forces ``use_pallas_coattention`` and
  ``use_pallas_self_attention`` onto the model config, so on the card every
  eligible attention — the 12 bridge directions and the 6 visual
  self-attentions of a forward at serving width — runs the hand-written
  flash kernel (ops/coattention.py). A failed build or launch raises; there
  is no degrade-to-dense path.
- **Weights.** Linear and Embedding weights are cast to the compute dtype
  once, at load. Flax's ``Dense(dtype=bf16)`` over f32 parameters casts the
  kernel, the bias and the input to bf16 before the product on every call,
  so the one cast at load is bit-equivalent. LayerNorm parameters stay f32,
  as flax's ``LayerNorm(dtype=bf16)`` uses them (statistics in f32).
- **Shapes.** Text is always ``max_text_len`` (37, +1 task token) and
  regions ``max_regions`` (101); the image axis pads to one of
  ``EngineConfig.image_buckets``. NLVR2 pairs and retrieval candidates score
  in one forward with the question replicated per image row.

Not in this package yet: the device row slab and input cache, ``run_many``,
warmup/CUDA graphs, meshes, int8 storage, and the serve tier.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vilbert_multitask_tpu_torch import assets
from vilbert_multitask_tpu_torch.config import (
    TASK_REGISTRY,
    FrameworkConfig,
    TaskSpec,
    ViLBertConfig,
)
from vilbert_multitask_tpu_torch.engine import decode as dec
from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
from vilbert_multitask_tpu_torch.features.pipeline import (
    RegionFeatures,
    batch_images,
    clip_regions,
    encode_image,
)
from vilbert_multitask_tpu_torch.features.store import FeatureStore
from vilbert_multitask_tpu_torch.models.heads import build_head_slabs
from vilbert_multitask_tpu_torch.models.vilbert import (
    ViLBertForVLTasks,
    ViLBertOutput,
    fused_head_output,
)
from vilbert_multitask_tpu_torch.text.pipeline import (
    EncodedText,
    encode_question,
)
from vilbert_multitask_tpu_torch.text.wordpiece import FullTokenizer

# The compute dtypes the flash kernel takes.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``torch.device`` for an engine: CUDA must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def init_state_dict(cfg: ViLBertConfig, seed: int = 0
                    ) -> Dict[str, torch.Tensor]:
    """Seeded random weights as an f32 CPU state dict (upstream keys),
    drawn from one ``torch.Generator``: Linear weights N(0, 1/fan_in) (the
    variance of flax's default lecun-normal), biases N(0, 0.02²), embedding
    rows N(0, 1/dim), LayerNorm weight 1 and bias 0. The JAX package's
    initializers have the same laws but other bits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        shapes = ViLBertForVLTasks(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for mname, mod in shapes.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, nn.LayerNorm):
            sd[pre + "weight"] = torch.ones(mod.weight.shape)
            sd[pre + "bias"] = torch.zeros(mod.bias.shape)
        elif isinstance(mod, nn.Embedding):
            n, d = mod.weight.shape
            sd[pre + "weight"] = torch.randn(n, d, generator=gen) / d ** 0.5
        elif isinstance(mod, nn.Linear):
            if pre + "weight" == "cls.predictions.decoder.weight":
                continue  # tied to the word embeddings, set below
            out_f, in_f = mod.weight.shape
            sd[pre + "weight"] = (torch.randn(out_f, in_f, generator=gen)
                                  / in_f ** 0.5)
            if mod.bias is not None:
                sd[pre + "bias"] = 0.02 * torch.randn(out_f, generator=gen)
    sd["cls.predictions.bias"] = torch.zeros(cfg.vocab_size)
    sd["cls.predictions.decoder.weight"] = sd[
        "bert.embeddings.word_embeddings.weight"]
    return sd


@dataclasses.dataclass
class PreparedRequest:
    """Host-side buffers for one request, already bucketed. ``features`` is
    a CPU tensor in the engine's transfer dtype (bf16 when the engine
    computes in bf16: the model casts its inputs to the compute dtype
    anyway, so the early cast is exact and halves the upload)."""

    spec: TaskSpec
    n_images: int
    bucket: int
    text: EncodedText  # (bucket, Nt)
    features: torch.Tensor  # (bucket, Nv, D) transfer dtype, on the CPU
    spatials: np.ndarray  # (bucket, Nv, 5) f32 (decode reads these host-side)
    image_mask: np.ndarray  # (bucket, Nv)
    task_ids: np.ndarray  # (bucket, 1)
    images: List[dec.ImageMeta]


def _to_host(tree):
    """Decode bundle → numpy (the one device→host fetch of a request)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_host(v) for v in tree)
    return tree.cpu().numpy()


class InferenceEngine:
    """One engine per process: owns the model, tokenizer and stores."""

    # Max label-decode fanout (TaskSpec.top_k ≤ 3 for the labels family).
    _TOPK = 3

    def __init__(
        self,
        cfg: Optional[FrameworkConfig] = None,
        *,
        params: Optional[Dict] = None,
        tokenizer: Optional[FullTokenizer] = None,
        feature_store: Optional[FeatureStore] = None,
        label_store: Optional[LabelMapStore] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg or FrameworkConfig()
        ecfg = self.cfg.engine
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The f32 parity runs compare with the CPU in full f32: TF32
            # (about three decimal digits) must not creep into any matmul
            # or convolution, whatever the process default.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if ecfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype {ecfg.compute_dtype}")
        self.compute_dtype = _DTYPES[ecfg.compute_dtype]
        # Engine kernel knobs win over the model config, unconditionally.
        self.model_config = dataclasses.replace(
            self.cfg.model,
            use_pallas_coattention=ecfg.use_pallas_coattention,
            use_pallas_self_attention=ecfg.use_pallas_self_attention,
        )
        self.tokenizer = tokenizer or FullTokenizer.from_vocab_file(
            ecfg.vocab_path or assets.default_vocab_path())
        self._check_vocab_coherence()
        self.feature_store = feature_store
        self.labels = label_store or LabelMapStore(
            root=ecfg.labels_root or assets.default_labels_root(),
            sizes={"vqa": self.cfg.model.num_labels,
                   "gqa": self.cfg.model.gqa_num_labels})
        # Task-id → label-head gather table for the fused decode bundle
        # (index 1 = the GQA head, 0 = the VQA head).
        n_tasks = max(TASK_REGISTRY) + 1
        self._gqa_gather = torch.tensor(
            [1 if (t in TASK_REGISTRY
                   and TASK_REGISTRY[t].head == "vil_prediction_gqa") else 0
             for t in range(n_tasks)], dtype=torch.long, device=self.device)
        self.stage_times: Dict[str, float] = {}
        # Built on the meta device (no allocation, no init kernels); the
        # weights land in load_params.
        with torch.device("meta"):
            self.model = ViLBertForVLTasks(self.model_config)
        self.model.to_empty(device=self.device)
        self.model.eval().requires_grad_(False)
        self.head_slabs: Optional[Dict[str, torch.Tensor]] = None
        self.load_params(self.init_params(seed) if params is None else params)

    # ------------------------------------------------------------------ init
    def _check_vocab_coherence(self) -> None:
        """Boot-time guard: the loaded vocab must fit the embedding table
        (an over-range token id would index out of it)."""
        n_vocab = len(self.tokenizer.vocab)
        n_rows = self.cfg.model.vocab_size
        if n_vocab > n_rows:
            raise ValueError(
                f"vocab file has {n_vocab} tokens but ViLBertConfig."
                f"vocab_size is {n_rows}: token ids would index out of the "
                f"embedding table. Fix vocab_path or vocab_size.")
        if n_rows > 2 * n_vocab:
            logging.getLogger(__name__).warning(
                "embedding table has %d rows but the vocab only %d tokens "
                "(%.0f%% dead weight) — expected with the committed "
                "synthetic vocab", n_rows, n_vocab,
                100 * (1 - n_vocab / n_rows))

    def init_params(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Seeded random weights for this engine's model (see
        :func:`init_state_dict`)."""
        return init_state_dict(self.model_config, seed)

    def load_params(self, params: Dict) -> None:
        """Load an upstream-layout state dict (numpy arrays or tensors; the
        reference checkpoint's keys, or ``checkpoint.convert.
        from_flax_params`` of a JAX tree) with ``strict=True``, cast the
        Linear/Embedding weights to the compute dtype, and rebuild the fused
        head slabs."""
        sd = {k: v if torch.is_tensor(v) else torch.tensor(np.asarray(v))
              for k, v in params.items()}
        model = self.model
        # Load in f32 (LayerNorm parameters stay there), then cast the
        # Linear/Embedding weights once.
        model.float()
        model.load_state_dict(sd, strict=True)
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.to(self.compute_dtype)
        self.head_slabs = (build_head_slabs(model, self.model_config)
                           if self.cfg.engine.fused_task_heads else None)

    # -------------------------------------------------------------- prepare
    @property
    def transfer_dtype(self) -> torch.dtype:
        """Dtype region features ship to the device in: the compute dtype
        when it is a 16-bit float, f32 otherwise."""
        if self.compute_dtype.is_floating_point and (
                self.compute_dtype.itemsize == 2):
            return self.compute_dtype
        return torch.float32

    def prepare_from_store(self, task_id: int, question: str,
                           image_paths: Sequence[str]) -> PreparedRequest:
        """prepare() with regions read from the attached feature store."""
        if self.feature_store is None:
            raise RuntimeError("prepare_from_store() needs a FeatureStore; "
                               "use prepare() with in-memory regions instead")
        t0 = time.perf_counter()
        regions = self.feature_store.get_batch(image_paths)
        fetch_s = time.perf_counter() - t0
        req = self.prepare(task_id, question, regions, image_paths)
        self.stage_times["features_s"] = (
            self.stage_times.get("features_s", 0.0) + fetch_s)
        return req

    def prepare(self, task_id: int, question: str,
                regions: Sequence[RegionFeatures],
                image_paths: Optional[Sequence[str]] = None
                ) -> PreparedRequest:
        """Host-side preprocessing: validate, tokenize, encode, bucket
        (reference ``custom_prediction``, worker.py:388-458, with the repeat
        semantics of worker.py:256-284)."""
        if task_id not in TASK_REGISTRY:
            raise ValueError(f"unknown task_id {task_id}")
        spec = TASK_REGISTRY[task_id]
        n = len(regions)
        spec.validate_num_images(n)
        ecfg = self.cfg.engine
        bucket = n if n == 1 else ecfg.bucket_for(n)

        t0 = time.perf_counter()
        text = encode_question(
            self.tokenizer, question, ecfg.max_text_len, task_id=task_id,
            lowercase=self.cfg.serving.lowercase_questions,
        ).stack(bucket)
        self.stage_times["tokenize_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        regions = clip_regions(regions, ecfg.max_regions,
                               num_features=ecfg.num_features)
        encoded = [encode_image(r, ecfg.max_regions) for r in regions]
        feats, spatials, image_mask = batch_images(encoded, pad_to=bucket)
        feats = torch.from_numpy(feats).to(self.transfer_dtype)
        self.stage_times["features_s"] = time.perf_counter() - t0
        task_ids = np.full((bucket, 1), task_id, np.int32)
        paths = list(image_paths or [f"image_{i}" for i in range(n)])
        if len(paths) != n:
            raise ValueError(
                f"got {len(paths)} image paths for {n} feature sets")
        images = [dec.ImageMeta(p, r.image_width, r.image_height)
                  for p, r in zip(paths, regions)]
        return PreparedRequest(spec, n, bucket, text, feats, spatials,
                               image_mask, task_ids, images)

    # ---------------------------------------------------------------- bundles
    @classmethod
    def _decode_bundle(cls, out: ViLBertOutput) -> dict:
        """Device-side decode prep for the per-head path: f32 softmax and
        top-3 of both label heads, f32 copies of the small heads."""
        f32 = lambda x: x.float()  # noqa: E731
        vqa = torch.topk(torch.softmax(f32(out.vil_prediction), -1), cls._TOPK)
        gqa = torch.topk(torch.softmax(f32(out.vil_prediction_gqa), -1),
                         cls._TOPK)
        return {
            "labels_top": {"vil_prediction": (vqa.values, vqa.indices),
                           "vil_prediction_gqa": (gqa.values, gqa.indices)},
            "vil_logit": f32(out.vil_logit),
            "vil_tri_prediction": f32(out.vil_tri_prediction),
            "vision_logit": f32(out.vision_logit),
            # The paired NLVR2 head only exists for even batches.
            **({"vil_binary_prediction": f32(out.vil_binary_prediction)}
               if out.vil_binary_prediction is not None else {}),
        }

    @classmethod
    def _fused_bundle(cls, out: ViLBertOutput, label_logits: torch.Tensor,
                      task_ids: torch.Tensor, gqa_gather: torch.Tensor
                      ) -> dict:
        """Decode bundle for the fused heads: ONE f32 softmax/top-3 over the
        label head gathered per row by task id, written under BOTH label
        keys so :meth:`decode` stays family-agnostic. Padded label columns
        sit at heads.PAD_LOGIT_BIAS and underflow to probability zero."""
        f32 = lambda x: x.float()  # noqa: E731
        sel = gqa_gather[task_ids[:, 0].clamp(0, gqa_gather.shape[0] - 1)]
        row = torch.take_along_dim(f32(label_logits), sel[:, None, None],
                                   dim=1)[:, 0]
        top = torch.topk(torch.softmax(row, -1), cls._TOPK)
        pair = (top.values, top.indices)
        return {
            "labels_top": {"vil_prediction": pair,
                           "vil_prediction_gqa": pair},
            "vil_logit": f32(out.vil_logit),
            "vil_tri_prediction": f32(out.vil_tri_prediction),
            "vision_logit": f32(out.vision_logit),
            **({"vil_binary_prediction": f32(out.vil_binary_prediction)}
               if out.vil_binary_prediction is not None else {}),
        }

    # ---------------------------------------------------------------- forward
    def _device_batch(self, req: PreparedRequest) -> dict:
        dev = self.device
        as_long = lambda a: torch.from_numpy(a).to(dev, torch.long)  # noqa: E731
        return dict(
            input_ids=as_long(req.text.input_ids),
            features=req.features.to(dev),
            spatials=torch.from_numpy(req.spatials).to(dev),
            segment_ids=as_long(req.text.segment_ids),
            input_mask=as_long(req.text.input_mask),
            image_mask=as_long(req.image_mask),
            task_ids=as_long(req.task_ids),
        )

    def bundle(self, req: PreparedRequest, *, collect_attention: bool = False
               ) -> Tuple[ViLBertOutput, dict]:
        """Upload, trunk + heads + decode bundle on the device, and the one
        blocking fetch of the few-KB bundle → (device output, host bundle)."""
        batch = self._device_batch(req)
        args = (batch["input_ids"], batch["features"], batch["spatials"],
                batch["segment_ids"], batch["input_mask"],
                batch["image_mask"], None, batch["task_ids"])
        with torch.inference_mode():
            if self.head_slabs is not None:
                trunk_out = self.model.trunk(
                    *args, output_all_attention_masks=collect_attention)
                out, label_logits = fused_head_output(
                    self.model_config, self.head_slabs, trunk_out,
                    batch["image_mask"], self.compute_dtype)
                bundle = self._fused_bundle(out, label_logits,
                                            batch["task_ids"],
                                            self._gqa_gather)
            else:
                out = self.model(
                    *args, output_all_attention_masks=collect_attention,
                    compute_pretraining_heads=False)
                bundle = self._decode_bundle(out)
        return out, _to_host(bundle)

    def run(self, req: PreparedRequest, *, collect_attention: bool = False
            ) -> Tuple[ViLBertOutput, dec.TaskResult]:
        """Device forward for a prepared request → (output, decoded result).
        ``forward_s`` spans upload, forward and the bundle fetch; decode is
        then pure host math."""
        t0 = time.perf_counter()
        out, bundle = self.bundle(req, collect_attention=collect_attention)
        self.stage_times["forward_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = self.decode(req, bundle)
        self.stage_times["decode_s"] = time.perf_counter() - t0
        return out, result

    # ---------------------------------------------------------------- decode
    def decode(self, req: PreparedRequest, bundle: dict, row: int = 0
               ) -> dec.TaskResult:
        """Decode one request from the host decode bundle, batch row ``row``."""
        spec = req.spec
        if spec.decode == "labels":
            top_p, top_i = bundle["labels_top"][spec.head]
            return dec.decode_labels_topk(spec, np.asarray(top_i)[row],
                                          np.asarray(top_p)[row], self.labels)
        if spec.decode == "binary":
            # paired head: batch row 2k/2k+1 → pair row k (row must be even)
            return dec.decode_binary(
                spec, np.asarray(bundle["vil_binary_prediction"])[row // 2])
        if spec.decode == "trinary":
            return dec.decode_trinary(
                spec, np.asarray(bundle["vil_tri_prediction"])[row])
        if spec.decode == "ranking":
            scores = np.asarray(bundle["vil_logit"])[
                row: row + len(req.images)]
            return dec.decode_ranking(spec, scores, req.images)
        if spec.decode == "grounding":
            return dec.decode_grounding(
                spec, np.asarray(bundle["vision_logit"])[row],
                req.spatials[0], req.images[0])
        raise ValueError(f"unknown decode family {spec.decode}")

    def predict(self, task_id: int, question: str,
                image_paths: Sequence[str], *,
                collect_attention: bool = False) -> dec.TaskResult:
        """Full request path: feature lookup → prepare → forward → decode."""
        if self.feature_store is None:
            raise RuntimeError("predict() needs a FeatureStore; use "
                               "prepare()+run() with in-memory regions instead")
        t0 = time.perf_counter()
        req = self.prepare_from_store(task_id, question, image_paths)
        self.stage_times["prepare_s"] = time.perf_counter() - t0
        _, result = self.run(req, collect_attention=collect_attention)
        return result
