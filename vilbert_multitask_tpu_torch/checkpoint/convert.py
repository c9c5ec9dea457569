"""JAX parameter tree → this package's torch ``state_dict``.

Counterpart of ``vilbert_multitask_tpu/checkpoint/convert.py``, numpy only.
:func:`from_flax_params` carries a JAX-package parameter tree (nested dicts
of numpy arrays, e.g. ``jax.device_get(engine.params)``) into the upstream
torch key layout this package's modules use, so

    model.load_state_dict(from_flax_params(params, cfg), strict=True)

loads it, exactly as the reference checkpoint (``pytorch_model_9.bin``)
would. The name map is this package's own copy of the JAX package's
``build_name_map``:

- a Flax kernel is (in, out), a torch ``Linear.weight`` (out, in): transpose;
- the fused ``qkv`` kernel splits into the upstream query/key/value linears;
- Flax ``LayerNorm.scale`` → ``LayerNorm.weight``;
- embedding tables pass through; the tied MLM decoder weight is the word
  embedding table.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from vilbert_multitask_tpu_torch.config import ViLBertConfig

# ---------------------------------------------------------------------------
# Name map. Each entry: flax path (tuple) → (torch keys, pack, unpack) where
# pack(torch arrays…) → flax array and unpack(flax array) → torch arrays.
# ---------------------------------------------------------------------------

Arr = np.ndarray


def _t(w: Arr) -> Arr:  # torch Linear weight → flax kernel
    return np.ascontiguousarray(w.T)


def _linear(flax_prefix: Tuple[str, ...], torch_prefix: str):
    return [
        (flax_prefix + ("kernel",), ([f"{torch_prefix}.weight"],
                                     lambda w: _t(w), lambda k: [_t(k)])),
        (flax_prefix + ("bias",), ([f"{torch_prefix}.bias"],
                                   lambda b: b, lambda b: [b])),
    ]


def _layernorm(flax_prefix: Tuple[str, ...], torch_prefix: str):
    return [
        (flax_prefix + ("scale",), ([f"{torch_prefix}.weight"],
                                    lambda w: w, lambda s: [s])),
        (flax_prefix + ("bias",), ([f"{torch_prefix}.bias"],
                                   lambda b: b, lambda b: [b])),
    ]


def _embed(flax_prefix: Tuple[str, ...], torch_key: str):
    return [(flax_prefix + ("embedding",),
             ([torch_key], lambda w: w, lambda e: [e]))]


def _fused_qkv(flax_prefix: Tuple[str, ...], torch_prefix: str):
    """query/key/value linears → one (in, 3·out) kernel + (3·out,) bias."""
    qkv = [f"{torch_prefix}.{n}" for n in ("query", "key", "value")]
    return [
        (flax_prefix + ("kernel",),
         ([f"{k}.weight" for k in qkv],
          lambda q, k, v: np.concatenate([_t(q), _t(k), _t(v)], axis=1),
          lambda ker: [_t(a) for a in np.split(ker, 3, axis=1)])),
        (flax_prefix + ("bias",),
         ([f"{k}.bias" for k in qkv],
          lambda q, k, v: np.concatenate([q, k, v]),
          lambda b: list(np.split(b, 3)))),
    ]


def build_name_map(cfg: ViLBertConfig):
    """flax-path → (torch keys, pack, unpack), for the full serving model."""
    m: List = []
    E = ("bert", "embeddings")
    m += _embed(E + ("word_embeddings",), "bert.embeddings.word_embeddings.weight")
    m += _embed(E + ("position_embeddings",),
                "bert.embeddings.position_embeddings.weight")
    m += _embed(E + ("token_type_embeddings",),
                "bert.embeddings.token_type_embeddings.weight")
    if cfg.task_specific_tokens:
        m += _embed(E + ("task_embeddings",),
                    "bert.embeddings.task_embeddings.weight")
    m += _layernorm(E + ("norm",), "bert.embeddings.LayerNorm")

    V = ("bert", "v_embeddings")
    m += _linear(V + ("image_embeddings",), "bert.v_embeddings.image_embeddings")
    m += _linear(V + ("image_location_embeddings",),
                 "bert.v_embeddings.image_location_embeddings")
    m += _layernorm(V + ("norm",), "bert.v_embeddings.LayerNorm")

    # Single-stream layers. Torch: bert.encoder.layer.{i} (text),
    # bert.encoder.v_layer.{i} (visual).
    def stream(n_layers: int, flax_fmt: str, torch_fmt: str):
        out = []
        for i in range(n_layers):
            F = ("bert", "encoder", flax_fmt.format(i))
            T = torch_fmt.format(i)
            out += _fused_qkv(F + ("attention", "qkv"), f"{T}.attention.self")
            out += _linear(F + ("attention_output", "dense"),
                           f"{T}.attention.output.dense")
            out += _layernorm(F + ("attention_output", "norm"),
                              f"{T}.attention.output.LayerNorm")
            out += _linear(F + ("ffn", "intermediate"), f"{T}.intermediate.dense")
            out += _linear(F + ("ffn", "output"), f"{T}.output.dense")
            out += _layernorm(F + ("ffn", "norm"), f"{T}.output.LayerNorm")
        return out

    m += stream(cfg.num_hidden_layers, "t_layer_{}", "bert.encoder.layer.{}")
    m += stream(cfg.v_num_hidden_layers, "v_layer_{}", "bert.encoder.v_layer.{}")

    # Co-attention bridges. Torch biattention convention (upstream vilbert):
    # *1 projections act on the VISUAL stream, *2 on TEXT. Text queries attend
    # image keys/values → (query2, key1, value1); image queries attend text →
    # (query1, key2, value2). biOutput.dense1/LayerNorm1 close the visual
    # residual, dense2/LayerNorm2 the text residual.
    for i in range(cfg.num_connection_layers):
        F = ("bert", "encoder", f"c_layer_{i}")
        T = f"bert.encoder.c_layer.{i}"
        for ours, theirs in (("query", "query2"), ("key", "key1"),
                             ("value", "value1")):
            m += _linear(F + ("text_attends_image", ours),
                         f"{T}.biattention.{theirs}")
        for ours, theirs in (("query", "query1"), ("key", "key2"),
                             ("value", "value2")):
            m += _linear(F + ("image_attends_text", ours),
                         f"{T}.biattention.{theirs}")
        m += _linear(F + ("v_output", "dense"), f"{T}.biOutput.dense1")
        m += _layernorm(F + ("v_output", "norm"), f"{T}.biOutput.LayerNorm1")
        m += _linear(F + ("t_output", "dense"), f"{T}.biOutput.dense2")
        m += _layernorm(F + ("t_output", "norm"), f"{T}.biOutput.LayerNorm2")
        m += _linear(F + ("v_ffn", "intermediate"), f"{T}.v_intermediate.dense")
        m += _linear(F + ("v_ffn", "output"), f"{T}.v_output.dense")
        m += _layernorm(F + ("v_ffn", "norm"), f"{T}.v_output.LayerNorm")
        m += _linear(F + ("t_ffn", "intermediate"), f"{T}.t_intermediate.dense")
        m += _linear(F + ("t_ffn", "output"), f"{T}.t_output.dense")
        m += _layernorm(F + ("t_ffn", "norm"), f"{T}.t_output.LayerNorm")

    m += _linear(("bert", "t_pooler", "dense"), "bert.t_pooler.dense")
    m += _linear(("bert", "v_pooler", "dense"), "bert.v_pooler.dense")

    # Masked-modeling heads (cls.*). Text decoder table is tied to the word
    # embedding — only its bias converts.
    m += _linear(("cls_text", "transform_dense"),
                 "cls.predictions.transform.dense")
    m += _layernorm(("cls_text", "transform_norm"),
                    "cls.predictions.transform.LayerNorm")
    m.append((("cls_text", "decoder_bias"),
              (["cls.predictions.bias"], lambda b: b, lambda b: [b])))
    m += _linear(("cls_image", "transform_dense"),
                 "cls.imagePredictions.transform.dense")
    m += _layernorm(("cls_image", "transform_norm"),
                    "cls.imagePredictions.transform.LayerNorm")
    m += _linear(("cls_image", "decoder"), "cls.imagePredictions.decoder")

    # Task heads. SimpleClassifier in torch is Sequential(Linear, GELU,
    # LayerNorm, Linear) → keys logit_fc.{0,2,3}.
    for head in ("vil_prediction", "vil_prediction_gqa",
                 "vil_binary_prediction"):
        m += _linear((head, "dense1"), f"{head}.logit_fc.0")
        m += _layernorm((head, "norm"), f"{head}.logit_fc.2")
        m += _linear((head, "dense2"), f"{head}.logit_fc.3")
    for head in ("vil_logit", "vil_tri_prediction", "vision_logit",
                 "linguisic_logit"):
        m += _linear((head,), head)
    return m


# ---------------------------------------------------------------------- api


def _get_path(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for k in path:
        node = node[k]
    return node


def from_flax_params(params: Dict, cfg: ViLBertConfig) -> Dict[str, Arr]:
    """Nested Flax param dict (numpy-valued) → upstream torch state dict of
    numpy arrays (plus the tied decoder weight torch materializes)."""
    out: Dict[str, Arr] = {}
    for flax_path, (torch_keys, _pack, unpack) in build_name_map(cfg):
        arrs = unpack(np.asarray(_get_path(params, flax_path)))
        for k, a in zip(torch_keys, arrs):
            out[k] = np.ascontiguousarray(a)
    # torch ties cls.predictions.decoder.weight to the embedding table.
    out["cls.predictions.decoder.weight"] = np.asarray(
        params["bert"]["embeddings"]["word_embeddings"]["embedding"])
    return out
