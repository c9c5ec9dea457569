"""Multi-task training loop: sampler → train step → checkpoint / resume.

Counterpart of ``vilbert_multitask_tpu/train/loop.py`` on one device (the
card unless the caller asks for the CPU). Its data half is
:mod:`.data`, re-exported here under the JAX module's names.

- **One step per head**: each head (a group for ``pretrain``) gets its own
  loss configuration, chosen per step by the sampler: the 12-in-1 regime's
  task alternation.
- **No kernel**: the trainer's model runs dense attention
  (``use_pallas_*=False``), as the JAX trainer's does; ``flash_attn`` has no
  backward. In-training evals (:class:`EvalHook`) run on the served engine,
  kernel included.
- **Full-state checkpoint / resume**: ``step_XXXXXXXX`` snapshots
  (``checkpoint.store.save_train_state``) every ``ckpt_every`` steps; resume
  picks up step, parameters, moments and the dropout generator where the
  newest snapshot left off, so a resumed run replays the uninterrupted
  run's batches and dropout masks.
- **On a mesh** (``Trainer(..., mesh=)``, one trainer per rank, every rank
  of the mesh running the same loop): the model is tensor-parallel
  (parallel/tp.py), every rank draws the same global batch from the step
  and runs its dp rows (train/step.py), snapshots are gathered and written
  by rank 0 in the single-device format, and a resume slices each rank's
  shard from it. ``EvalHook(..., mesh=)`` evaluates on a mesh engine over
  the sharded parameters: rank 0 runs the harness while the other ranks
  follow its dispatches.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vilbert_multitask_tpu_torch import obs
from vilbert_multitask_tpu_torch.config import FrameworkConfig
from vilbert_multitask_tpu_torch.train.data import (  # noqa: F401 — re-exported
    HEAD_LOSS_GROUPS,
    HEAD_TASK_IDS,
    JsonlTaskData,
    MultiTaskSampler,
    SyntheticTaskData,
    apply_mlm_masking,
    apply_mrm_masking,
    iou_grounding_target,
    vqa_soft_target,
)
from vilbert_multitask_tpu_torch.train.losses import LossConfig
from vilbert_multitask_tpu_torch.train.step import (
    TrainState,
    create_train_state,
    default_optimizer,
    make_train_step,
)

STEP_DIR_RE = re.compile(r"^step_(\d{8})$")


def latest_checkpoint(out_dir: str) -> Optional[Tuple[str, int]]:
    """(path, step) of the newest ``step_XXXXXXXX`` snapshot under
    ``out_dir``."""
    try:
        entries = os.listdir(out_dir)
    except OSError:
        return None
    best = None
    for name in entries:
        mt = STEP_DIR_RE.match(name)
        if mt:
            step = int(mt.group(1))
            if best is None or step > best[1]:
                best = (os.path.join(out_dir, name), step)
    return best


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 1000
    batch_size: int = 8
    learning_rate: float = 4e-5
    warmup_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 200
    keep_ckpts: int = 3
    seed: int = 0
    retrieval_group_size: int = 2
    # 0 disables; otherwise Trainer calls its eval_fn(step, state) at this
    # cadence (and at the final step) and logs the returned scores.
    eval_every: int = 0


class EvalHook:
    """In-training evaluation on the serving path: the trainer's current
    parameters go into an ``InferenceEngine`` and the eval harness scores
    it, decode included (evals/harness.py), so the scores are what a
    deployed worker would answer.

    The engine is built once, at the first eval, on ``device`` with the
    configuration's engine settings (on the card: bf16, fused heads and one
    CUDA graph per bucket, so attention runs ``flash_attn``). Later evals
    copy the parameters into the engine's existing tensors
    (``load_params``): the captured graphs read those addresses.
    """

    # Result fields that are metadata, not scores.
    _META_KEYS = frozenset({"task_id", "n", "wall_s", "metric"})

    def __init__(self, cfg: FrameworkConfig, feature_store,
                 tasks: Dict[str, Sequence[Dict]], *, batch: int = 8,
                 label_store=None, tokenizer=None, mesh=None,
                 device="cuda"):
        from vilbert_multitask_tpu_torch.evals.harness import Evaluator

        unknown = set(tasks) - set(Evaluator.EVAL_FNS)
        if unknown:
            raise ValueError(
                f"unknown eval tasks {sorted(unknown)}; the harness serves "
                f"{sorted(Evaluator.EVAL_FNS)}")
        self.cfg = cfg
        self.store = feature_store
        self.tasks = dict(tasks)
        self.batch = batch
        self.label_store = label_store
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.mesh = mesh
        self._engine = None

    def __call__(self, step: int, state: TrainState) -> Dict[str, float]:
        from vilbert_multitask_tpu_torch.engine.runtime import InferenceEngine
        from vilbert_multitask_tpu_torch.evals.harness import Evaluator

        from vilbert_multitask_tpu_torch.parallel.mesh import world_axis
        from vilbert_multitask_tpu_torch.parallel.sharding import (
            ShardedStateDict,
        )

        params = {k: v.detach() for k, v in state.state_dict().items()}
        if self.mesh is not None:  # this rank's shards of the parameters
            params = ShardedStateDict(params)
        if self._engine is None:
            self._engine = InferenceEngine(
                self.cfg, params=params, feature_store=self.store,
                label_store=self.label_store, tokenizer=self.tokenizer,
                mesh=self.mesh, device=self.device)
            if self.device.type == "cuda":
                self._engine.warmup()
        else:
            self._engine.load_params(params)
        if world_axis(self.mesh).index != 0:
            self._engine.follow()  # rank 0 scores; the others follow it
            return {}
        ev = Evaluator(self._engine, batch=self.batch)
        out: Dict[str, float] = {}
        try:
            for task, examples in self.tasks.items():
                scores = ev.run(task, examples)
                for k, v in scores.items():
                    if (k not in self._META_KEYS
                            and isinstance(v, (int, float))):
                        out[f"eval/{task}/{k}"] = round(float(v), 5)
        finally:
            self._engine.stop_followers()
        return out


class Trainer:
    """Owns the model, the optimizer, the train state and the per-head
    steps. ``init_params`` is an upstream-key state dict (default: seeded
    random weights, ``engine.runtime.init_state_dict``); ``device`` is where
    it trains (``"cuda"`` unless the caller asks for ``"cpu"``)."""

    def __init__(self, cfg: FrameworkConfig, sampler: MultiTaskSampler,
                 loop: LoopConfig, *, out_dir: Optional[str] = None,
                 init_params=None,
                 eval_fn: Optional[Callable[[int, TrainState],
                                            Dict[str, float]]] = None,
                 log_fn: Callable[[str], None] = print, mesh=None,
                 device="cuda"):
        from vilbert_multitask_tpu_torch.checkpoint.store import (
            restore_train_state,
        )
        from vilbert_multitask_tpu_torch.engine.runtime import (
            _DTYPES,
            init_state_dict,
            resolve_device,
        )
        from vilbert_multitask_tpu_torch.models.vilbert import (
            ViLBertForVLTasks,
        )
        from vilbert_multitask_tpu_torch.parallel.ring import RingContext
        from vilbert_multitask_tpu_torch.parallel.sharding import (
            shard_state_dict,
        )
        from vilbert_multitask_tpu_torch.parallel.tp import (
            layout,
            parallelize,
        )

        self.cfg, self.sampler, self.loop = cfg, sampler, loop
        self.out_dir, self.log, self.eval_fn = out_dir, log_fn, eval_fn
        self.device = resolve_device(device)
        self.mesh = mesh
        # The contrastive loss reshapes by loop.retrieval_group_size; a
        # dataset laying out another group width would score distractors
        # as positives.
        for head, ds in sampler.datasets.items():
            ds_group = getattr(ds, "group_size", None)
            if (head == "retrieval" and ds_group is not None
                    and ds_group != loop.retrieval_group_size):
                raise ValueError(
                    f"retrieval dataset group_size={ds_group} != "
                    f"LoopConfig.retrieval_group_size="
                    f"{loop.retrieval_group_size}")
        if cfg.engine.compute_dtype not in _DTYPES:
            raise ValueError(f"unsupported compute_dtype "
                             f"{cfg.engine.compute_dtype}")
        # f32 master parameters; the forward computes in the engine's
        # compute dtype under autocast. Dense attention: no kernel here.
        compute = _DTYPES[cfg.engine.compute_dtype]
        self.autocast_dtype = None if compute == torch.float32 else compute
        model_cfg = dataclasses.replace(cfg.model,
                                        use_pallas_coattention=False,
                                        use_pallas_self_attention=False)
        if init_params is None:
            init_params = init_state_dict(model_cfg, loop.seed)
        ring_v = RingContext.from_mesh(
            mesh, min_seq=cfg.engine.ring_min_regions)
        with torch.device("meta"):  # no host init of weights loaded next
            self.model = ViLBertForVLTasks(model_cfg, ring_v=ring_v)
            if mesh is not None:
                parallelize(self.model, mesh)
        self.model.to_empty(device=self.device)
        self.model.tie_weights()
        weights = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                      else v).float()
                   for k, v in init_params.items()}
        if mesh is not None:
            weights = shard_state_dict(weights, mesh, layout(self.model))
        self.model.load_state_dict(weights, strict=True)
        self.model.train()
        self.tx = default_optimizer(
            learning_rate=loop.learning_rate, warmup_steps=loop.warmup_steps,
            total_steps=loop.total_steps)
        self._steps: Dict[str, Callable] = {}  # head → its step
        self.state = create_train_state(self.model, self.tx, seed=loop.seed,
                                        mesh=mesh)
        resumed = latest_checkpoint(out_dir) if out_dir else None
        if resumed is not None:
            path, step = resumed
            restore_train_state(path, self.state)
            self.log(f"# resumed from {path} at step {step}")

    def _step_for(self, head: str) -> Callable:
        if head not in self._steps:
            loss_cfg = LossConfig(
                heads=HEAD_LOSS_GROUPS.get(head, (head,)),
                retrieval_group_size=self.loop.retrieval_group_size)
            self._steps[head] = make_train_step(
                self.model, self.tx, loss_cfg,
                autocast_dtype=self.autocast_dtype)
        return self._steps[head]

    def _save(self, step: int) -> None:
        from vilbert_multitask_tpu_torch.checkpoint.store import (
            save_train_state,
        )

        from vilbert_multitask_tpu_torch.parallel.mesh import world_axis

        save_train_state(os.path.join(self.out_dir, f"step_{step:08d}"),
                         self.state)
        if world_axis(self.mesh).index != 0:
            return  # rank 0 wrote the snapshot and keeps the retention
        # Retention: keep the newest keep_ckpts snapshots.
        snaps = sorted(
            n for n in os.listdir(self.out_dir) if STEP_DIR_RE.match(n))
        for name in snaps[: -self.loop.keep_ckpts]:
            shutil.rmtree(os.path.join(self.out_dir, name),
                          ignore_errors=True)

    def train(self) -> Dict[str, float]:
        """Run to ``loop.total_steps`` from the resumed step; returns the
        last logged metrics."""
        lp = self.loop
        start = self.state.step
        last_metrics: Dict[str, float] = {}
        t0 = time.perf_counter()
        window = start
        for step in range(start, lp.total_steps):
            with obs.span("train.data", step=step):
                head, batch = self.sampler.next(lp.batch_size, step)
            with obs.span("train.step", step=step, head=head):
                self.state, metrics = self._step_for(head)(self.state, batch)
            now = step + 1
            if now % lp.log_every == 0 or now == lp.total_steps:
                values = torch.stack(list(metrics.values())).tolist()
                m = {k: round(float(v), 5) for k, v in zip(metrics, values)}
                if not np.isfinite(m.get("loss/total", 0.0)):
                    # Fail at the first logged divergence, not after the
                    # rest of the budget burns on NaN updates; the last
                    # snapshot is the restart point.
                    raise FloatingPointError(
                        f"non-finite loss at step {now} (head {head}): {m}")
                dt = time.perf_counter() - t0
                m.update(step=now, head=head,
                         steps_per_s=round((now - window) / max(dt, 1e-9), 3))
                self.log(json.dumps(m))
                last_metrics = m
                t0, window = time.perf_counter(), now
            if (self.eval_fn is not None and lp.eval_every
                    and (now % lp.eval_every == 0 or now == lp.total_steps)):
                scores = self.eval_fn(now, self.state)
                self.log(json.dumps({"step": now, **scores}))
            if self.out_dir and (now % lp.ckpt_every == 0
                                 or now == lp.total_steps):
                # Never snapshot a diverged state: the checkpoint and log
                # cadences differ, so the loss may have gone non-finite
                # since the last logged check.
                if not np.isfinite(float(metrics["loss/total"])):
                    raise FloatingPointError(
                        f"non-finite loss at step {now} (head {head}); "
                        f"snapshot NOT written")
                with obs.span("train.checkpoint", step=now):
                    self._save(now)
        return last_metrics


def main(argv=None) -> None:
    """``python -m vilbert_multitask_tpu_torch.train.loop``: multi-task
    training on synthetic or JSONL data, on the card unless ``--cpu``."""
    import argparse

    p = argparse.ArgumentParser(
        description="ViLBERT multi-task trainer (PyTorch/CUDA port)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--heads", default="vqa,tri,grounding",
                   help="comma list of heads "
                        f"(choices: {sorted(HEAD_TASK_IDS)})")
    p.add_argument("--out", default=None, help="checkpoint/resume dir")
    p.add_argument("--data-root", default=None,
                   help="dir with <head>.jsonl files + features/ store; "
                        "omit for synthetic shape-correct data")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CPU smoke)")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the CUDA device)")
    p.add_argument("--lr", type=float, default=4e-5)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-every", type=int, default=200)
    p.add_argument("--mesh", default=None, metavar="DP,TP[,SP]",
                   help="train on a process mesh of this shape (dp -1: "
                        "the remaining ranks); the ranks come from the "
                        "launcher (python -m vilbert_multitask_tpu_torch."
                        "parallel.launch --nproc N --backend gloo|nccl -- "
                        "vilbert_multitask_tpu_torch.train.loop ...)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run the eval harness on the current params every N "
                        "steps (needs --data-root with eval_<task>.jsonl "
                        "files; tasks: vqa/gqa/grounding/visual7w/"
                        "retrieval/nlvr2)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    cfg = FrameworkConfig()
    mesh = None
    if args.mesh:
        from vilbert_multitask_tpu_torch.parallel import build_mesh
        from vilbert_multitask_tpu_torch.parallel.distributed import (
            initialize,
        )
        from vilbert_multitask_tpu_torch.parallel.mesh import parse_mesh

        cfg = dataclasses.replace(cfg, mesh=parse_mesh(args.mesh))
        if not initialize(device=device):
            raise SystemExit("--mesh needs the launcher's ranks "
                             "(parallel/launch.py)")
        mesh = build_mesh(cfg.mesh)
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=cfg.model.tiny())
    heads = [h.strip() for h in args.heads.split(",") if h.strip()]

    datasets: Dict[str, object] = {}
    if args.data_root:
        from vilbert_multitask_tpu_torch import assets
        from vilbert_multitask_tpu_torch.engine.labels import LabelMapStore
        from vilbert_multitask_tpu_torch.features.store import FeatureStore
        from vilbert_multitask_tpu_torch.text.wordpiece import FullTokenizer

        store = FeatureStore(os.path.join(args.data_root, "features"))
        tok = FullTokenizer.from_vocab_file(
            cfg.engine.vocab_path or assets.default_vocab_path())
        labels = LabelMapStore(
            root=cfg.engine.labels_root or assets.default_labels_root(),
            sizes={"vqa": cfg.model.num_labels,
                   "gqa": cfg.model.gqa_num_labels})
        for h in heads:
            label_map = (labels.get("vqa") if h == "vqa"
                         else labels.get("gqa") if h == "gqa" else None)
            datasets[h] = JsonlTaskData(
                h, os.path.join(args.data_root, f"{h}.jsonl"), store, tok,
                cfg, label_map=label_map)
    else:
        for h in heads:
            datasets[h] = SyntheticTaskData(h, cfg)

    loop = LoopConfig(total_steps=args.steps, batch_size=args.batch,
                      learning_rate=args.lr, log_every=args.log_every,
                      ckpt_every=args.ckpt_every, eval_every=args.eval_every,
                      warmup_steps=max(1, args.steps // 10))
    eval_fn = None
    if args.eval_every and not args.data_root:
        print("# --eval-every needs --data-root (eval_<task>.jsonl files); "
              "no evals will run")
    if args.eval_every and args.data_root:
        from vilbert_multitask_tpu_torch.evals.harness import (
            Evaluator,
            load_jsonl,
        )

        eval_tasks = {}
        for name in sorted(Evaluator.EVAL_FNS):
            path = os.path.join(args.data_root, f"eval_{name}.jsonl")
            if os.path.exists(path):
                eval_tasks[name] = load_jsonl(path)
        if eval_tasks:
            eval_fn = EvalHook(cfg, store, eval_tasks, label_store=labels,
                               tokenizer=tok, mesh=mesh, device=device)
            print(f"# eval tasks: {sorted(eval_tasks)}")
        else:
            print("# --eval-every set but no eval_<task>.jsonl under "
                  "--data-root; skipping evals")
    trainer = Trainer(cfg, MultiTaskSampler(datasets), loop,
                      out_dir=args.out, eval_fn=eval_fn, mesh=mesh,
                      device=device)
    final = trainer.train()
    print(json.dumps({"final": final}))
    if mesh is not None:
        from vilbert_multitask_tpu_torch.parallel.distributed import shutdown

        shutdown()


if __name__ == "__main__":
    main()
