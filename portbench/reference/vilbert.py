"""Plain PyTorch reference of the 12-in-1 ViLBERT trunk and its nine heads.

Written from the published architecture (``bert_base_6layer_6conect``:
a BERT-base text stream, a 6-layer visual stream and six co-attention
bridges joining text layers 6-11 to visual layers 0-5) over a state dict
in the upstream key layout. Every product runs in float32 with TF32 off;
there are no kernels, graphs, caches or batching tricks. Post-LayerNorm
BERT layers, exact-erf GELU, the -10000 mask penalty, the task token
inserted after [CLS] without a position embedding, the pooled vectors
fused by product, the NLVR2 head on row pairs.

``int8=True`` computes with the weights stored as int8 would give them:
every matrix quantized per output row (per hidden column for the lookup
tables) with a symmetric scale ``max|w| / 127`` and rounded half to even,
then dequantized; the VQA and GQA classifiers' matrices quantized again
as the stacked pair a fused head holds, one scale per output column over
both heads. The product itself stays float32.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

_TABLE = re.compile(r"(word|position|token_type|task)_embeddings\.weight$")


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes the reference needs, as the configuration files name
    them."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    v_feature_size: int = 2048
    v_target_size: int = 1601
    v_hidden_size: int = 1024
    v_num_hidden_layers: int = 6
    v_num_attention_heads: int = 8
    v_intermediate_size: int = 1024
    bi_hidden_size: int = 1024
    bi_num_attention_heads: int = 8
    v_biattention_id: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    t_biattention_id: Tuple[int, ...] = (6, 7, 8, 9, 10, 11)
    num_task_tokens: int = 20
    num_labels: int = 3129
    gqa_num_labels: int = 1533
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_config(cls, cfg: dict) -> "Dims":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in cfg.items() if k in names}
        return cls(**kw)


def param_shapes(d: Dims) -> Iterator[Tuple[str, tuple, str]]:
    """(upstream key, shape, kind) of every leaf the served model loads;
    kind is ``linear``, ``bias``, ``table``, ``ln_weight``, ``ln_bias`` or
    ``zeros``, which the seeded weights read."""
    h, hv, bi = d.hidden_size, d.v_hidden_size, d.bi_hidden_size

    def lin(key, n_out, n_in):
        yield f"{key}.weight", (n_out, n_in), "linear"
        yield f"{key}.bias", (n_out,), "bias"

    def ln(key, n):
        yield f"{key}.weight", (n,), "ln_weight"
        yield f"{key}.bias", (n,), "ln_bias"

    e = "bert.embeddings"
    yield f"{e}.word_embeddings.weight", (d.vocab_size, h), "table"
    yield f"{e}.position_embeddings.weight", (d.max_position_embeddings,
                                              h), "table"
    yield f"{e}.token_type_embeddings.weight", (d.type_vocab_size, h), "table"
    yield f"{e}.task_embeddings.weight", (d.num_task_tokens, h), "table"
    yield from ln(f"{e}.LayerNorm", h)
    v = "bert.v_embeddings"
    yield from lin(f"{v}.image_embeddings", hv, d.v_feature_size)
    yield from lin(f"{v}.image_location_embeddings", hv, 5)
    yield from ln(f"{v}.LayerNorm", hv)
    for stream, n_layers, width, inter in (
            ("layer", d.num_hidden_layers, h, d.intermediate_size),
            ("v_layer", d.v_num_hidden_layers, hv, d.v_intermediate_size)):
        for i in range(n_layers):
            p = f"bert.encoder.{stream}.{i}"
            for name in ("query", "key", "value"):
                yield from lin(f"{p}.attention.self.{name}", width, width)
            yield from lin(f"{p}.attention.output.dense", width, width)
            yield from ln(f"{p}.attention.output.LayerNorm", width)
            yield from lin(f"{p}.intermediate.dense", inter, width)
            yield from lin(f"{p}.output.dense", width, inter)
            yield from ln(f"{p}.output.LayerNorm", width)
    for i in range(len(d.v_biattention_id)):
        p = f"bert.encoder.c_layer.{i}"
        for name in ("query1", "key1", "value1"):
            yield from lin(f"{p}.biattention.{name}", bi, hv)
        for name in ("query2", "key2", "value2"):
            yield from lin(f"{p}.biattention.{name}", bi, h)
        yield from lin(f"{p}.biOutput.dense1", hv, bi)
        yield from ln(f"{p}.biOutput.LayerNorm1", hv)
        yield from lin(f"{p}.biOutput.dense2", h, bi)
        yield from ln(f"{p}.biOutput.LayerNorm2", h)
        yield from lin(f"{p}.v_intermediate.dense", d.v_intermediate_size, hv)
        yield from lin(f"{p}.v_output.dense", hv, d.v_intermediate_size)
        yield from ln(f"{p}.v_output.LayerNorm", hv)
        yield from lin(f"{p}.t_intermediate.dense", d.intermediate_size, h)
        yield from lin(f"{p}.t_output.dense", h, d.intermediate_size)
        yield from ln(f"{p}.t_output.LayerNorm", h)
    yield from lin("bert.t_pooler.dense", bi, h)
    yield from lin("bert.v_pooler.dense", bi, hv)
    for head, n_in, n_out in (("vil_prediction", bi, d.num_labels),
                              ("vil_prediction_gqa", bi, d.gqa_num_labels),
                              ("vil_binary_prediction", 2 * bi, 2)):
        yield from lin(f"{head}.logit_fc.0", 2 * bi, n_in)
        yield from ln(f"{head}.logit_fc.2", 2 * bi)
        yield from lin(f"{head}.logit_fc.3", n_out, 2 * bi)
    yield from lin("vil_logit", 1, bi)
    yield from lin("vil_tri_prediction", 3, bi)
    yield from lin("vision_logit", 1, hv)
    yield from lin("linguisic_logit", 1, h)
    # The pretraining heads: loaded by the served model, never computed.
    yield "cls.predictions.bias", (d.vocab_size,), "zeros"
    c = "cls.predictions.transform"
    yield from lin(f"{c}.dense", h, h)
    yield from ln(f"{c}.LayerNorm", h)
    c = "cls.imagePredictions"
    yield from lin(f"{c}.transform.dense", hv, hv)
    yield from ln(f"{c}.transform.LayerNorm", hv)
    yield from lin(f"{c}.decoder", d.v_target_size, hv)


def _quantize(w: torch.Tensor, axis: int, kind: str = "int8"
              ) -> torch.Tensor:
    """Symmetric per-channel int8 (or float8 e4m3) along ``axis``,
    dequantized (f32)."""
    w = w.float()
    axis = axis % w.dim()
    dims = tuple(a for a in range(w.dim()) if a != axis)
    amax = w.abs().amax(dim=dims, keepdim=True)
    top = 127.0 if kind == "int8" else 448.0
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / top)
    if kind == "fp8":
        return (w / scale).to(torch.float8_e4m3fn).float() * scale
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def _quantize_pair(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two (out, in) matrices stacked as one (2, in, out_max) slab with one
    scale per output column over both, as the fused label pair holds
    them; returns each dequantized in its own shape."""
    width = max(a.shape[0], b.shape[0])
    slab = torch.stack([F.pad(a, (0, 0, 0, width - a.shape[0])),
                        F.pad(b, (0, 0, 0, width - b.shape[0]))])
    amax = slab.abs().amax(dim=(0, 2), keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax),
                        amax * (1.0 / 127.0))
    deq = torch.clamp(torch.round(slab / scale), -127, 127) * scale
    return deq[0, :a.shape[0]], deq[1, :b.shape[0]]


def reference_weights(sd: Dict[str, torch.Tensor], d: Dims, *,
                      int8: bool = False, compute: Optional[str] = None
                      ) -> Dict[str, torch.Tensor]:
    """The f32 leaves the reference computes with. ``compute`` ("int8" or
    "fp8") is the reference in that compute precision, the control of a
    bf16 configuration: every matrix quantized per output row (per hidden
    column for the tables), and every Linear's input quantized per row
    (symmetric, ``max|x|`` to 127 or to float8 e4m3's 448) before the
    product."""
    out = {}
    for key, _shape, _kind in param_shapes(d):
        w = sd[key].float()
        if (int8 or compute) and w.dim() >= 2:
            w = _quantize(w, -1 if _TABLE.search(key) else 0,
                          compute or "int8")
        out[key] = w
    if int8:
        for layer in ("logit_fc.0", "logit_fc.3"):
            ka = f"vil_prediction.{layer}.weight"
            kb = f"vil_prediction_gqa.{layer}.weight"
            out[ka], out[kb] = _quantize_pair(out[ka], out[kb])
    if compute:
        out[_COMPUTE] = compute
    return out


_COMPUTE = "<quantized compute>"


def _lin(w, key, x):
    kind = w.get(_COMPUTE)
    if kind:  # one scale a row of the product's input
        x = _quantize(x.reshape(-1, x.shape[-1]), 0, kind).reshape(x.shape)
    return F.linear(x, w[f"{key}.weight"], w[f"{key}.bias"])


def _ln(w, key, x, eps):
    return F.layer_norm(x, (x.shape[-1],), w[f"{key}.weight"],
                        w[f"{key}.bias"], eps)


def _attention(w, x, y, bias, q_key, k_key, v_key, heads):
    q, k, v = _lin(w, q_key, x), _lin(w, k_key, y), _lin(w, v_key, y)
    B, nq, width = q.shape
    nk, dh = k.shape[1], width // heads
    q = q.view(B, nq, heads, dh).transpose(1, 2)
    k = k.view(B, nk, heads, dh).transpose(1, 2)
    v = v.view(B, nk, heads, dh).transpose(1, 2)
    scores = q @ k.transpose(-1, -2) / math.sqrt(dh) + bias
    ctx = torch.softmax(scores, dim=-1) @ v
    return ctx.transpose(1, 2).reshape(B, nq, width)


def _ffn(w, inter, out, x, eps):
    return _ln(w, f"{out}.LayerNorm",
               _lin(w, f"{out}.dense", F.gelu(_lin(w, inter, x))) + x, eps)


def _layer(w, p, x, bias, heads, eps):
    ctx = _attention(w, x, x, bias, f"{p}.attention.self.query",
                     f"{p}.attention.self.key", f"{p}.attention.self.value",
                     heads)
    x = _ln(w, f"{p}.attention.output.LayerNorm",
            _lin(w, f"{p}.attention.output.dense", ctx) + x, eps)
    return _ffn(w, f"{p}.intermediate.dense", f"{p}.output", x, eps)


def _bridge(w, p, v, v_bias, t, t_bias, heads, eps):
    b = f"{p}.biattention"
    t_ctx = _attention(w, t, v, v_bias, f"{b}.query2", f"{b}.key1",
                       f"{b}.value1", heads)
    v_ctx = _attention(w, v, t, t_bias, f"{b}.query1", f"{b}.key2",
                       f"{b}.value2", heads)
    o = f"{p}.biOutput"
    v = _ln(w, f"{o}.LayerNorm1", _lin(w, f"{o}.dense1", v_ctx) + v, eps)
    t = _ln(w, f"{o}.LayerNorm2", _lin(w, f"{o}.dense2", t_ctx) + t, eps)
    v = _ffn(w, f"{p}.v_intermediate.dense", f"{p}.v_output", v, eps)
    t = _ffn(w, f"{p}.t_intermediate.dense", f"{p}.t_output", t, eps)
    return v, t


def _classifier(w, head, x, eps):
    h = F.gelu(_lin(w, f"{head}.logit_fc.0", x))
    return _lin(w, f"{head}.logit_fc.3", _ln(w, f"{head}.logit_fc.2", h, eps))


def forward(w: Dict[str, torch.Tensor], d: Dims, batch: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """Logits of every served head for a batch of rows: ``input_ids``,
    ``segment_ids``, ``input_mask`` (B, Nt), ``task_ids`` (B,),
    ``features`` (B, Nv, F), ``spatials`` (B, Nv, 5), ``image_mask`` (B,
    Nv). ``vil_binary_prediction`` pairs rows 2k and 2k+1 and is present
    for an even B."""
    eps = d.layer_norm_eps
    ids, seg, mask = batch["input_ids"], batch["segment_ids"], \
        batch["input_mask"]
    B, nt = ids.shape
    e = "bert.embeddings"
    x = (F.embedding(ids, w[f"{e}.word_embeddings.weight"])
         + w[f"{e}.position_embeddings.weight"][:nt][None]
         + F.embedding(seg, w[f"{e}.token_type_embeddings.weight"]))
    task = F.embedding(batch["task_ids"], w[f"{e}.task_embeddings.weight"])
    t = _ln(w, f"{e}.LayerNorm",
            torch.cat([x[:, :1], task[:, None], x[:, 1:]], dim=1), eps)
    t_mask = torch.cat([mask[:, :1], torch.ones_like(mask[:, :1]),
                        mask[:, 1:]], dim=1)
    ve = "bert.v_embeddings"
    v = _ln(w, f"{ve}.LayerNorm",
            _lin(w, f"{ve}.image_embeddings", batch["features"].float())
            + _lin(w, f"{ve}.image_location_embeddings",
                   batch["spatials"].float()), eps)
    t_bias = ((1.0 - t_mask.float()) * -10000.0)[:, None, None, :]
    v_bias = ((1.0 - batch["image_mask"].float()) * -10000.0)[:, None, None, :]
    ti = vi = 0
    for c, (v_stop, t_stop) in enumerate(zip(d.v_biattention_id,
                                             d.t_biattention_id)):
        while ti < t_stop:
            t = _layer(w, f"bert.encoder.layer.{ti}", t, t_bias,
                       d.num_attention_heads, eps)
            ti += 1
        while vi < v_stop:
            v = _layer(w, f"bert.encoder.v_layer.{vi}", v, v_bias,
                       d.v_num_attention_heads, eps)
            vi += 1
        v, t = _bridge(w, f"bert.encoder.c_layer.{c}", v, v_bias, t, t_bias,
                       d.bi_num_attention_heads, eps)
    while vi < d.v_num_hidden_layers:
        v = _layer(w, f"bert.encoder.v_layer.{vi}", v, v_bias,
                   d.v_num_attention_heads, eps)
        vi += 1
    while ti < d.num_hidden_layers:
        t = _layer(w, f"bert.encoder.layer.{ti}", t, t_bias,
                   d.num_attention_heads, eps)
        ti += 1
    pooled = (torch.relu(_lin(w, "bert.t_pooler.dense", t[:, 0]))
              * torch.relu(_lin(w, "bert.v_pooler.dense", v[:, 0])))
    out = {
        "vil_prediction": _classifier(w, "vil_prediction", pooled, eps),
        "vil_prediction_gqa": _classifier(w, "vil_prediction_gqa", pooled,
                                          eps),
        "vil_logit": _lin(w, "vil_logit", pooled)[:, 0],
        "vil_tri_prediction": _lin(w, "vil_tri_prediction", pooled),
        "vision_logit": _lin(w, "vision_logit", v)[..., 0] + v_bias[:, 0, 0],
    }
    if B % 2 == 0:
        out["vil_binary_prediction"] = _classifier(
            w, "vil_binary_prediction", pooled.reshape(B // 2, -1), eps)
    return out
