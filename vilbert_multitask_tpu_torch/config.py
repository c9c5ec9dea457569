"""The port's typed config tree (a copy of the JAX package's config.py).

Field names are the JAX package's own (``vilbert_multitask_tpu/config.py``),
so one config JSON or one ``dataclasses.asdict`` dump feeds both packages:

- :class:`ViLBertConfig`   — the model (mirrors config/bert_base_6layer_6conect.json
  plus the overrides applied at reference worker.py:509-522).
- :class:`TaskSpec` / :data:`TASK_REGISTRY` — the served task types.
- :class:`EngineConfig`    — the inference-engine fields this package reads.
- :class:`ServingConfig`   — the serving fields the engine reads.
- :class:`FrameworkConfig` — the root aggregate; :meth:`FrameworkConfig.from_dict`
  takes a JAX-package config dump and ignores the fields this package lacks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class ViLBertConfig:
    """Two-stream ViLBERT architecture knobs.

    Field names follow the reference config JSON (``bert_base_6layer_6conect.json``,
    loaded at reference worker.py:472,495) so checkpoints and configs translate
    1:1. Defaults are the values the reference demo actually serves with,
    including the runtime overrides at worker.py:509-523 (``v_target_size=1601``,
    ``predict_feature=False``, ``task_specific_tokens=True``,
    ``visualization=True``, ``num_labels=3129``).
    """

    # --- text stream (BERT-base) ---
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    # --- visual stream ---
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    v_hidden_act: str = "gelu"
    v_hidden_dropout_prob: float = 0.1
    v_attention_probs_dropout_prob: float = 0.1
    v_initializer_range: float = 0.02

    # --- co-attention bridge ---
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    bi_intermediate_size: int = 1024
    # Text layer i in t_biattention_id co-attends with visual layer j at the
    # same position in v_biattention_id ("6 connect" in the config name).
    v_biattention_id: Sequence[int] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Sequence[int] = (6, 7, 8, 9, 10, 11)
    fusion_method: str = "mul"  # pooled_t ∘ pooled_v fusion for vil_* heads

    # --- behavior flags (reference worker.py:509-523) ---
    predict_feature: bool = False
    task_specific_tokens: bool = True
    num_task_tokens: int = 20  # task-token embedding table size
    dynamic_attention: bool = False
    visualization: bool = True  # return per-layer attention maps (10th output)
    # Run the co-attention bridges through the flash attention kernel
    # (ops/coattention.py, csrc/flash_attn.cu). Off when attention maps are
    # requested — the blockwise kernel never materializes probabilities.
    # The field names are the JAX package's, so one config feeds both.
    use_pallas_coattention: bool = False
    # Same kernel for the single-stream self-attention; a stream only takes
    # the kernel path when its head_dim is a multiple of 128 (the 1024/8
    # visual stream is; BERT-base text's 64 is not and stays dense).
    use_pallas_self_attention: bool = False
    # Training-only knob of the JAX package (layer rematerialization); kept
    # so configs round-trip, unused here (this package serves only).
    remat: bool = False

    # --- heads ---
    num_labels: int = 3129  # VQA answer space (worker.py:523)
    gqa_num_labels: int = 1533  # GQA answer space (12-in-1 head width)

    def __post_init__(self):
        if len(self.v_biattention_id) != len(self.t_biattention_id):
            raise ValueError("v_biattention_id and t_biattention_id must pair up")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide num_attention_heads")
        if self.v_hidden_size % self.v_num_attention_heads:
            raise ValueError("v_hidden_size must divide v_num_attention_heads")
        if self.bi_hidden_size % self.bi_num_attention_heads:
            raise ValueError("bi_hidden_size must divide bi_num_attention_heads")

    @property
    def num_connection_layers(self) -> int:
        return len(self.v_biattention_id)

    @classmethod
    def from_json_file(cls, path: str) -> "ViLBertConfig":
        """Load a reference-format config JSON (ignores unknown keys)."""
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["v_biattention_id"] = list(self.v_biattention_id)
        d["t_biattention_id"] = list(self.t_biattention_id)
        return json.dumps(d, indent=2, sort_keys=True)

    def tiny(self, **overrides) -> "ViLBertConfig":
        """A scaled-down config for CPU tests (same topology, small dims)."""
        small = dict(
            # >= the committed assets/wordpiece_vocab.txt size, so tiny
            # models accept ids from the default serving tokenizer.
            vocab_size=1088,
            hidden_size=48,
            num_hidden_layers=4,
            num_attention_heads=4,
            intermediate_size=64,
            max_position_embeddings=64,
            v_feature_size=32,
            v_target_size=11,
            v_hidden_size=32,
            v_num_hidden_layers=2,
            v_num_attention_heads=2,
            v_intermediate_size=32,
            bi_hidden_size=32,
            bi_num_attention_heads=2,
            bi_intermediate_size=32,
            v_biattention_id=(0, 1),
            t_biattention_id=(2, 3),
            num_labels=17,
            gqa_num_labels=13,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One served task type (reference: UI dropdown result.html:318-336 +
    worker dispatch worker.py:250-263,295-386)."""

    task_id: int
    name: str
    head: str  # which model output decodes this task
    decode: str  # decode family: "labels" | "binary" | "trinary" | "ranking" | "grounding"
    min_images: int
    max_images: int
    top_k: int  # how many ranked answers the demo shows
    label_map: str | None = None  # key into the label-map store, if any
    description: str = ""
    placeholder: str = ""

    def validate_num_images(self, n: int) -> None:
        """Image-count gating, matching the asserts at worker.py:256-263."""
        if not (self.min_images <= n <= self.max_images):
            raise ValueError(
                f"task {self.task_id} ({self.name}) requires "
                f"{self.min_images}..{self.max_images} images, got {n}"
            )


# The 8 served task types. task_id values are the reference's wire protocol —
# they appear in queue messages (demo/sender.py:26-31) and the UI (result.html:318-336).
TASK_REGISTRY: Mapping[int, TaskSpec] = {
    t.task_id: t
    for t in [
        TaskSpec(1, "VQA", head="vil_prediction", decode="labels", min_images=1,
                 max_images=1, top_k=3, label_map="vqa",
                 description="Visual question answering (VQAv2)",
                 placeholder="e.g. What is the man holding?"),
        TaskSpec(2, "VQA-variant", head="vil_prediction", decode="labels", min_images=1,
                 max_images=1, top_k=3, label_map="vqa",
                 description="Alias of VQA; decodable but absent from the reference UI "
                             "(worker.py:295,564 vs result.html:318-336)"),
        TaskSpec(15, "GQA", head="vil_prediction_gqa", decode="labels", min_images=1,
                 max_images=1, top_k=3, label_map="gqa",
                 description="Spatial-reasoning QA (GQA)",
                 placeholder="e.g. Is the bowl to the right of the mug?"),
        TaskSpec(4, "Visual7W", head="vision_logit", decode="grounding", min_images=1,
                 max_images=1, top_k=3,
                 description="Pointing QA — answer is a box",
                 placeholder="e.g. Which object can you eat?"),
        TaskSpec(11, "RefCOCO", head="vision_logit", decode="grounding", min_images=1,
                 max_images=1, top_k=3,
                 description="Referring-expression grounding",
                 placeholder="e.g. the woman in the red coat"),
        TaskSpec(16, "GuessWhat", head="vision_logit", decode="grounding", min_images=1,
                 max_images=1, top_k=3,
                 description="Referring dialog grounding (Q:..? A:.. format)",
                 placeholder="e.g. Q: is it a person? A: no Q: is it red? A: yes"),
        TaskSpec(13, "SNLI-VE", head="vil_tri_prediction", decode="trinary", min_images=1,
                 max_images=1, top_k=3,
                 description="Visual entailment: contradiction/neutral/entailment",
                 placeholder="e.g. Two dogs are playing in the snow."),
        TaskSpec(12, "NLVR2", head="vil_binary_prediction", decode="binary", min_images=2,
                 max_images=2, top_k=2,
                 description="Does the caption describe the image pair? True/False",
                 placeholder="e.g. Both images contain exactly two wolves."),
        TaskSpec(7, "Retrieval", head="vil_logit", decode="ranking", min_images=2,
                 max_images=10, top_k=0,  # top_k=#images, resolved at decode time
                 description="Caption-based image retrieval over the uploaded set",
                 placeholder="e.g. A man riding a horse on the beach."),
    ]
}

# Decode label maps that are fixed (not loaded from disk).
NLVR2_LABELS = ("False", "True")  # worker.py:327
SNLI_VE_LABELS = ("contradiction (false)", "neutral", "entailment (true)")  # worker.py:342


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The inference-engine fields the port reads (a subset of the JAX
    package's EngineConfig, same names and defaults)."""

    max_text_len: int = 37  # wordpiece tokens incl. [CLS]/[SEP] (worker.py:408)
    max_regions: int = 101  # 100 detector boxes + 1 global feature (worker.py:71,433)
    num_features: int = 100  # detector boxes kept per image (worker.py:71)
    # Shape buckets for the image axis: NLVR2 needs 2, retrieval 2..10
    # (worker.py:256-284).
    image_buckets: Sequence[int] = (1, 2, 4, 8, 10)
    compute_dtype: str = "bfloat16"
    # Run the nine per-task decode heads as ONE batched program (stacked
    # weight slabs + a per-row gather by task id) instead of nine small
    # matmuls. Off → the per-head module path, which the tests hold it to.
    fused_task_heads: bool = True
    # The engine forces these onto the model config: serving runs the flash
    # attention kernel for every eligible attention (see ViLBertConfig).
    use_pallas_coattention: bool = True
    use_pallas_self_attention: bool = True
    # Text/label assets. None → the committed copies in this package's assets/.
    vocab_path: str | None = None
    labels_root: str | None = None

    def bucket_for(self, n_images: int) -> int:
        for b in self.image_buckets:
            if n_images <= b:
                return b
        raise ValueError(f"no shape bucket holds {n_images} images")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The serving field the engine reads (the queue/HTTP tier is not ported)."""

    lowercase_questions: bool = True  # reference lowercases server-side (views.py:27)


def _known(cls, raw: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in raw.items() if k in names}


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    model: ViLBertConfig = dataclasses.field(default_factory=ViLBertConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "FrameworkConfig":
        """Build from a nested dict such as ``dataclasses.asdict`` of the
        JAX package's FrameworkConfig; keys this package lacks are ignored."""
        return cls(
            model=ViLBertConfig(**_known(ViLBertConfig, raw.get("model", {}))),
            engine=EngineConfig(**_known(EngineConfig, raw.get("engine", {}))),
            serving=ServingConfig(**_known(ServingConfig,
                                           raw.get("serving", {}))),
        )
