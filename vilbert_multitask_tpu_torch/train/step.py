"""The train step: forward, the multi-task loss, backward and an AdamW update.

Counterpart of ``vilbert_multitask_tpu/train/step.py`` on one device. The
optimizer is the JAX package's ``default_optimizer`` (``optax.chain(
clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(...)))``) in
optax's own arithmetic, not ``torch.optim``'s:

- the gradient is left alone while its global norm is below the limit, and
  is otherwise ``(g / norm) * max_norm`` (``clip_grad_norm_`` divides by
  ``norm + 1e-6``);
- Adam's moments are ``(1 - b)·g^k + b·m``, bias-corrected by
  ``1 - b^count`` with the count after the increment; the update is
  ``m̂ / (sqrt(v̂) + eps)`` plus ``weight_decay · p`` on the decayed leaves,
  scaled by ``-lr(count)`` with the count before the increment;
- the schedule and the bias corrections are computed in the parameters'
  dtype, as optax computes them.

The parameters are the model's own ``nn.Parameter`` objects, updated in
place (``foreach`` ops: a few dozen launches for the whole update, not a
few per parameter). A parameter autograd left without a gradient (a head
the step's loss does not read) takes a zero gradient, as a JAX gradient
tree has one for every leaf: its moments decay and its weight decays.

Mixed precision: the JAX trainer computes in bf16 over f32 master
parameters (``Trainer``, loop.py:615-620); here the parameters stay f32 and
the forward runs under ``torch.autocast`` (``make_train_step``'s
``autocast_dtype``); the losses are f32 either way.

On a mesh (``create_train_state(..., mesh=)`` over a model made
tensor-parallel by ``parallel.tp.parallelize``; the JAX package's
``shard_train_state``):

- each rank holds its tp shard of every parameter, and Adam's moments
  mirror it; AdamW runs on the shards;
- every rank draws the same global batch; the model runs on this rank's
  dp rows (``place_batch(..., global_batch=True)``) and its outputs are
  all-gathered over dp, so every rank computes the loss of the global
  batch, as the JAX step does; each rank's gradient then holds its rows'
  part, and the dp ranks' gradients are summed (all-reduce);
- the global norm for clipping sums the squared norms of the tp-sharded
  leaves over tp and counts each replicated leaf once, accumulating in
  f64;
- the dropout generator is seeded ``seed + dp index``: the tp ranks of one
  dp group draw the same masks for their replicated activations, and the
  dp groups draw their own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vilbert_multitask_tpu_torch.models.layers import set_dropout_generator
from vilbert_multitask_tpu_torch.train.losses import LossConfig, multitask_loss

MODEL_INPUTS = ("input_ids", "features", "spatials", "segment_ids",
                "input_mask", "image_mask")


@dataclasses.dataclass
class TrainState:
    """Step, parameters (name → tensor: the model's own parameters in a
    model-bound state), Adam's two moments by the same names, and the
    dropout generator (in a host state read from a checkpoint, the
    generator's saved state; ``None`` where there is none).
    ``aliases`` names the state-dict keys that share a parameter (the MLM
    decoder tied to the word embeddings): the update and the checkpoint
    see the parameter once."""

    step: int
    params: Dict[str, torch.Tensor]
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    generator: Optional[torch.Generator] = None
    aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    # The process mesh, and the dim each tp-sharded parameter is split on
    # (parallel.tp.shard_dims); None / empty on one device.
    mesh: Any = None
    shard_dims: Dict[str, int] = dataclasses.field(default_factory=dict)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The parameters under every upstream key the model's
        ``state_dict`` has (what ``load_state_dict`` and the inference
        engine's ``load_params`` take)."""
        out = dict(self.params)
        for alias, name in self.aliases.items():
            out[alias] = self.params[name]
        return out


def is_decayed(name: str, param: torch.Tensor) -> bool:
    """Weight decay on leaves with ``ndim >= 2`` not named ``bias`` or
    ``scale`` (the JAX package's mask, step.py:50-57): in the upstream key
    layout the Linear and Embedding weights; never LayerNorm weights."""
    return param.ndim >= 2 and name.rsplit(".", 1)[-1] not in ("bias",
                                                               "scale")


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float, *,
                        sharded: Optional[Sequence[bool]] = None,
                        tp_axis=None
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients as they are while
    their global norm is below ``max_norm``, else ``(g / norm) * max_norm``
    (new tensors); and the norm, in the gradients' dtype. Each leaf's norm
    is accumulated in f64: torch's f32 norm on the CPU sums in f32 and
    reads a leaf of millions of elements low (the full-width word
    embeddings hold 23 M).

    On a mesh, ``sharded[i]`` says whether ``grads[i]`` is this rank's tp
    shard of its leaf: the squared norms of the sharded leaves are summed
    over ``tp_axis`` and each replicated leaf (the same on every tp rank)
    is counted once."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float64)
    if tp_axis is None or tp_axis.size == 1:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        from vilbert_multitask_tpu_torch.parallel import comm

        sq = torch.stack(norms) ** 2
        mask = torch.tensor(list(sharded), device=sq.device)
        parts = torch.stack([sq[mask].sum(), sq[~mask].sum()])
        shard_sq = comm.all_reduce(parts[:1].clone(), tp_axis)
        norm = torch.sqrt(shard_sq[0] + parts[1])
    norm = norm.to(grads[0].dtype)
    if bool(norm < max_norm):
        return grads, norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    return clipped, norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``clip_by_global_norm(grad_clip)`` then optax's ``adamw`` over
    ``warmup_cosine_decay_schedule(0, learning_rate, warmup_steps,
    decay_steps)`` (from 0, down to 0)."""

    learning_rate: float = 4e-5
    warmup_steps: int = 1000
    decay_steps: int = 100_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int, dtype: torch.dtype) -> float:
        """The learning rate at optimizer ``count`` (optax's
        ``join_schedules`` of a linear warmup and a cosine decay), computed
        in ``dtype`` on the host."""
        warm, peak = self.warmup_steps, self.learning_rate
        if count < warm:
            c = torch.tensor(float(min(max(count, 0), warm)), dtype=dtype)
            value = (0.0 - peak) * (1 - c / warm) + peak
        else:
            span = self.decay_steps - warm
            c = torch.minimum(torch.tensor(float(count - warm), dtype=dtype),
                              torch.tensor(float(span), dtype=dtype))
            value = peak * (0.5 * (1 + torch.cos(c * math.pi / span)))
        return float(value)

    def init(self, params: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Zero first and second moments, one per parameter."""
        return ({k: torch.zeros_like(p) for k, p in params.items()},
                {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, state: TrainState,
               grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update to ``state``'s parameters and moments in place
        (the step count is the caller's); returns the raw gradients'
        global norm."""
        names = list(state.params)
        params = [state.params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        dtype = params[0].dtype
        tp = None
        if state.mesh is not None:
            from vilbert_multitask_tpu_torch.parallel.mesh import axis

            tp = axis(state.mesh, "tp")
        g, norm = clip_by_global_norm(
            g, self.grad_clip, sharded=[k in state.shard_dims for k in names],
            tp_axis=tp)
        # mu = (1 - b1)·g + b1·mu ; nu = (1 - b2)·g² + b2·nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        del g2
        count = state.step + 1
        bc1 = float(1 - torch.tensor(self.b1, dtype=dtype) ** count)
        bc2 = float(1 - torch.tensor(self.b2, dtype=dtype) ** count)
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        decayed = [i for i, k in enumerate(names)
                   if is_decayed(k, params[i])]
        if decayed and self.weight_decay:
            torch._foreach_add_(
                [upd[i] for i in decayed],
                torch._foreach_mul([params[i] for i in decayed],
                                   self.weight_decay))
        torch._foreach_mul_(upd, -self.schedule(state.step, dtype))
        torch._foreach_add_(params, upd)
        return norm


def default_optimizer(learning_rate: float = 4e-5, weight_decay: float = 0.01,
                      warmup_steps: int = 1000, total_steps: int = 100_000,
                      grad_clip: float = 1.0) -> AdamW:
    """AdamW + linear warmup / cosine decay + global-norm clip (the BERT
    fine-tuning recipe; the JAX package's ``default_optimizer``)."""
    return AdamW(learning_rate=learning_rate, warmup_steps=warmup_steps,
                 decay_steps=max(total_steps, warmup_steps + 1),
                 weight_decay=weight_decay, grad_clip=grad_clip)


def create_train_state(model: nn.Module, tx: AdamW, *,
                       seed: int = 0, mesh=None) -> TrainState:
    """Step 0 over ``model``'s parameters, zero moments, and a dropout
    generator on the parameters' device seeded with ``seed`` (given to
    every dropout of the model). On a ``mesh`` the model is this rank's
    tp-parallel one: its parameters are shards, the moments mirror them,
    and the generator is seeded ``seed + dp index``."""
    params = dict(model.named_parameters())
    by_id = {id(p): k for k, p in params.items()}
    aliases = {k: by_id[id(v)]
               for k, v in model.state_dict(keep_vars=True).items()
               if k not in params and id(v) in by_id}
    device = next(iter(params.values())).device
    dims: Dict[str, int] = {}
    if mesh is not None:
        from vilbert_multitask_tpu_torch.parallel.mesh import axis
        from vilbert_multitask_tpu_torch.parallel.tp import shard_dims

        dims = shard_dims(model)
        seed += axis(mesh, "dp").index
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    set_dropout_generator(model, generator)
    mu, nu = tx.init(params)
    return TrainState(step=0, params=params, mu=mu, nu=nu,
                      generator=generator, aliases=aliases, mesh=mesh,
                      shard_dims=dims)


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """This rank's shard of a train state of global tensors (e.g. a
    snapshot read on the host, or ``train.convert.from_jax_train_state``):
    parameters and both moments sliced by the same rules
    (``parallel.sharding.shard_state_dict``), ready for
    :func:`load_train_state` into a mesh state."""
    from vilbert_multitask_tpu_torch.parallel.sharding import (
        shard_state_dict,
    )

    return dataclasses.replace(
        state, params=dict(shard_state_dict(state.params, mesh)),
        mu=dict(shard_state_dict(state.mu, mesh)),
        nu=dict(shard_state_dict(state.nu, mesh)), mesh=mesh)


@torch.no_grad()
def load_train_state(state: TrainState, source: TrainState) -> TrainState:
    """Copy ``source`` (e.g. a checkpoint read on the host, or
    ``train.convert.from_jax_train_state``) into ``state``'s own tensors, in
    place: step, parameters, moments and, when ``source`` carries one, the
    generator state. The keys must match exactly."""
    for what in ("params", "mu", "nu"):
        mine, theirs = getattr(state, what), getattr(source, what)
        missing, unexpected = set(mine) - set(theirs), set(theirs) - set(mine)
        if missing or unexpected:
            raise KeyError(f"train state {what}: missing {sorted(missing)[:3]}"
                           f", unexpected {sorted(unexpected)[:3]}")
        for k, t in mine.items():
            t.copy_(torch.as_tensor(theirs[k]))
    if isinstance(source.generator, torch.Tensor):
        state.generator.set_state(source.generator)
    state.step = int(source.step)
    return state


def batch_tensors(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A sampler batch (numpy arrays) as tensors on ``device``: integer
    arrays as int64, floating ones as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
        t = t.long() if not t.is_floating_point() else t.float()
        out[k] = t.to(device, non_blocking=True)
    return out


def _gather_rows(out, dp):
    """Every tensor of a model output all-gathered over dp along its rows
    (differentiable: the gradient goes back to this rank's rows)."""
    from vilbert_multitask_tpu_torch.parallel.tp import gather_from_tp

    return dataclasses.replace(out, **{
        f.name: gather_from_tp(getattr(out, f.name), dp, 0)
        for f in dataclasses.fields(out)
        if isinstance(getattr(out, f.name), torch.Tensor)})


def _sum_over(tensors: List[torch.Tensor], ax) -> None:
    """Sum ``tensors`` over the axis in place, one all-reduce per dtype."""
    from torch._utils import (
        _flatten_dense_tensors,
        _unflatten_dense_tensors,
    )

    from vilbert_multitask_tpu_torch.parallel import comm

    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = comm.all_reduce(_flatten_dense_tensors(group), ax)
        for t, summed in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(summed)


def make_train_step(model: nn.Module, tx: AdamW, loss_cfg: LossConfig, *,
                    autocast_dtype: Optional[torch.dtype] = None
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState,
                                                             Dict]]:
    """The step for one loss configuration: ``step_fn(state, batch) →
    (state, metrics)``, the state updated in place and returned.

    The model's mode decides dropout (``model.train()``, as the JAX step's
    ``deterministic=False``; ``eval()`` turns it off). ``metrics`` holds the
    ``loss/<head>`` and ``loss/total`` values and ``grad_norm``, the global
    norm of the raw gradients, as device scalars."""

    def step_fn(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        device = next(iter(state.params.values())).device
        b = batch_tensors(batch, device)
        x, rows_sharded = b, False
        if state.mesh is not None:
            from vilbert_multitask_tpu_torch.parallel.mesh import axis
            from vilbert_multitask_tpu_torch.parallel.sharding import (
                place_batch,
                shards_batch,
            )

            dp = axis(state.mesh, "dp")
            rows_sharded = shards_batch(b["input_ids"].shape[0], dp.size)
            x = place_batch({k: b[k] for k in (*MODEL_INPUTS, "task_ids")
                             if k in b}, state.mesh, global_batch=True)
        with torch.autocast(device.type, dtype=autocast_dtype or
                            torch.bfloat16,
                            enabled=autocast_dtype is not None):
            out = model(*(x[k] for k in MODEL_INPUTS), None,
                        x.get("task_ids"))
        if rows_sharded:
            out = _gather_rows(out, dp)
        loss, metrics = multitask_loss(loss_cfg, out, b)
        for p in state.params.values():
            p.grad = None
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in state.params.items()}
        if rows_sharded:
            _sum_over(list(grads.values()), dp)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = tx.update(state, grads)
        for p in state.params.values():
            p.grad = None
        state.step += 1
        return state, metrics

    return step_fn
