"""The port's own checkpoints: save, restore, restore in the background.

Counterpart of ``vilbert_multitask_tpu/checkpoint/store.py`` (``save_params``,
``restore_params``, ``AsyncRestore``, ``restore_params_async``, :19-111).
A checkpoint is a directory holding ``params.pt``: ``torch.save`` of the
upstream-key state dict (the keys ``load_state_dict`` takes, quantized
``{"int8", "scale"}`` pairs included), read back with ``torch.load(...,
weights_only=True)``. The JAX package's Orbax directories are not read
here; ``convert.from_flax_params`` carries a JAX tree across.

:func:`restore_params` also reads a single torch file, the reference's
``pytorch_model_*.bin`` (:func:`..convert.load_torch_checkpoint`), and
casts what it read to the serving storage dtype on the host, before any
upload: ``dtype="int8"`` quantizes (quant.py), a floating dtype casts the
floating leaves. Restores come back on the host; the engine's
``load_params`` places them.

:func:`save_train_state` / :func:`restore_train_state` (the JAX store's
:114 and :130) snapshot the trainer's whole state: a directory holding
``train_state.pt``, ``torch.save`` of the step, the parameters, Adam's two
moments and the dropout generator's state, read back into a template
state's own tensors. The directory is written whole under a temporary
name and renamed into place.

On a process mesh (parallel/) the files stay global: a mesh save gathers
the tp shards and rank 0 writes the same format; a mesh restore reads the
global file on every rank and slices each rank's shard. A snapshot written
on a mesh restores on one device, and the reverse.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import torch

from vilbert_multitask_tpu_torch import quant
from vilbert_multitask_tpu_torch.checkpoint.convert import (
    check_keys,
    load_torch_checkpoint,
    read_torch_state_dict,
)

PARAMS_FILE = "params.pt"
TRAIN_STATE_FILE = "train_state.pt"


def save_params(path: str, params: Dict[str, Any], *,
                force: bool = False) -> None:
    """Save an upstream-key state dict (tensors, arrays or pairs, on any
    device) as a checkpoint directory. ``force`` replaces an existing
    checkpoint (re-runnable flows such as the onboarding CLI); without it
    an existing one raises ``FileExistsError``."""
    path = os.path.abspath(path)
    target = os.path.join(path, PARAMS_FILE)
    if os.path.exists(target) and not force:
        raise FileExistsError(f"{target} exists (pass force=True)")
    host = {}
    for key, value in params.items():
        value = quant.leaf_to(value, "cpu")
        host[key] = ({k: v.contiguous() for k, v in value.items()}
                     if quant.is_quantized_leaf(value)
                     else value.contiguous())
    os.makedirs(path, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save(host, tmp)
    os.replace(tmp, target)  # a reader never sees a partial file


def cast_params(params: Dict[str, Any], dtype) -> Dict[str, Any]:
    """The serving storage cast (``EngineConfig.param_dtype``): ``None``
    leaves the tree as it is, ``"int8"`` quantizes it (pairs pass
    through), a floating dtype casts the floating leaves and keeps pairs."""
    if dtype is None:
        return params
    if dtype == "int8":
        return quant.quantize_tree(params)
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"param storage dtype must be floating or 'int8', "
                         f"got {dtype!r}")
    return {k: (v.to(dt) if torch.is_tensor(v) and v.is_floating_point()
                else v) for k, v in params.items()}


def restore_params(path: str, *, dtype=None,
                   cfg=None, mesh=None) -> Dict[str, Any]:
    """Restore a state dict on the host from a checkpoint directory
    (:func:`save_params`) or a torch file (an upstream ``.bin``), cast to
    ``dtype`` (:func:`cast_params`). With ``cfg`` (a ``ViLBertConfig``)
    the keys are checked against its model first. A checkpoint saved from
    an int8 engine restores unchanged: quantizing is idempotent. With a
    ``mesh``, this rank's shard of the cast tree (a
    ``parallel.sharding.ShardedStateDict``, which a mesh engine's
    ``load_params`` takes as it is), sliced as ``cfg``'s model is laid out
    on that mesh (``parallel.tp.layout_for``: an attention whose heads tp
    does not divide stays whole); without ``cfg``, by the per-leaf
    rules."""
    if os.path.isdir(path):
        sd = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                        weights_only=True)
        if cfg is not None:
            check_keys(sd, cfg, path)
    elif cfg is not None:
        sd = load_torch_checkpoint(path, cfg)
    else:
        sd = read_torch_state_dict(path)
    sd = cast_params(sd, dtype)
    if mesh is None:
        return sd
    from vilbert_multitask_tpu_torch.parallel.sharding import shard_state_dict
    from vilbert_multitask_tpu_torch.parallel.tp import layout_for

    return shard_state_dict(
        sd, mesh, None if cfg is None else layout_for(cfg, mesh))


class AsyncRestore:
    """Handle on a background :func:`restore_params`: ``join()`` returns
    the restored state dict (re-raising any restore failure) and
    ``seconds`` says how long the restore ran."""

    def __init__(self, thread: threading.Thread, box: dict):
        self._thread = thread
        self._box = box

    def join(self) -> Dict[str, Any]:
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["params"]

    @property
    def seconds(self) -> float:
        """Wall time of the restore itself (valid after join())."""
        return self._box.get("seconds", 0.0)


def restore_params_async(path: str, *, dtype=None,
                         cfg=None, mesh=None) -> AsyncRestore:
    """:func:`restore_params` on a background thread, so that reading and
    quantizing the checkpoint overlaps the rest of a boot."""
    box: dict = {}

    def _run() -> None:
        t0 = time.perf_counter()
        try:
            box["params"] = restore_params(path, dtype=dtype, cfg=cfg,
                                           mesh=mesh)
        except BaseException as e:  # noqa: BLE001 — joined and re-raised
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=_run, daemon=True,
                              name="checkpoint-restore")
    thread.start()
    return AsyncRestore(thread, box)


def _gathered(tree: Dict[str, torch.Tensor], state: Any) -> Dict:
    """A state's parameters or moments with every tp shard gathered."""
    from vilbert_multitask_tpu_torch.parallel import comm
    from vilbert_multitask_tpu_torch.parallel.mesh import axis

    tp = axis(state.mesh, "tp")
    return {k: (comm.all_gather(v.detach(), tp, state.shard_dims[k])
                if k in state.shard_dims else v)
            for k, v in tree.items()}


def _generator_states(state: Any) -> Optional[torch.Tensor]:
    """Every dp rank's dropout-generator state, (dp, n) uint8 (None at
    dp = 1)."""
    from vilbert_multitask_tpu_torch.parallel import comm
    from vilbert_multitask_tpu_torch.parallel.mesh import axis

    dp = axis(state.mesh, "dp")
    if state.generator is None or dp.size == 1:
        return None
    dev = next(iter(state.params.values())).device
    mine = state.generator.get_state()[None].to(dev)
    return comm.all_gather(mine, dp, 0).cpu()


def _mesh_barrier(state: Any) -> None:
    from vilbert_multitask_tpu_torch.parallel import comm
    from vilbert_multitask_tpu_torch.parallel.mesh import world_axis

    dev = next(iter(state.params.values())).device
    comm.all_reduce(torch.zeros(1, device=dev), world_axis(state.mesh))


def save_train_state(path: str, state: Any) -> None:
    """Save a ``train.step.TrainState`` (step, parameters, moments and the
    dropout generator's state) as the directory ``path``, copied to the
    host. The whole snapshot is written into a sibling directory
    (``<path>.tmp-<pid>``, a name ``train.loop.STEP_DIR_RE`` never
    matches) and renamed to ``path`` when complete: a trainer killed
    mid-save leaves no ``path`` behind, so a resume scan never sees a
    partial snapshot. An existing ``path`` is refused
    (``FileExistsError``), as the JAX store's Orbax save refuses it.

    On a mesh (``state.mesh``) every rank calls it: the tp shards are
    gathered, rank 0 writes the global snapshot (with every dp rank's
    generator state under ``dp_generators``) and the ranks wait for it."""
    def host(tree):
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

    path = os.path.abspath(path.rstrip(os.sep))
    trees = (state.params, state.mu, state.nu)
    writer, gens = True, None
    if state.mesh is not None:
        from vilbert_multitask_tpu_torch.parallel.mesh import world_axis

        trees = tuple(_gathered(t, state) for t in trees)
        gens = _generator_states(state)
        writer = world_axis(state.mesh).index == 0
    if writer:
        if os.path.exists(path):
            raise FileExistsError(f"{path} exists")
        tmp = f"{path}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            snap = {"step": int(state.step), "params": host(trees[0]),
                    "mu": host(trees[1]), "nu": host(trees[2]),
                    "generator": (state.generator.get_state()
                                  if state.generator is not None else None)}
            if gens is not None:
                snap["dp_generators"] = gens
            torch.save(snap, os.path.join(tmp, TRAIN_STATE_FILE))
            os.replace(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    if state.mesh is not None:
        _mesh_barrier(state)


def restore_train_state(path: str, template: Any) -> Any:
    """Restore a snapshot of :func:`save_train_state` into ``template`` (a
    freshly built ``TrainState`` of the same model: its tensors receive the
    values in place, on their own device, and its generator the saved
    state). Returns the template. A mesh template (``template.mesh``)
    takes this rank's shard of the global snapshot, and its dp rank's
    generator state when the snapshot has one per dp rank of this mesh."""
    from vilbert_multitask_tpu_torch.train.step import (
        TrainState,
        load_train_state,
        shard_train_state,
    )

    raw = torch.load(os.path.join(path, TRAIN_STATE_FILE),
                     map_location="cpu", weights_only=True)
    source = TrainState(step=raw["step"], params=raw["params"], mu=raw["mu"],
                        nu=raw["nu"], generator=raw["generator"])
    if template.mesh is not None:
        from vilbert_multitask_tpu_torch.parallel.mesh import axis

        source = shard_train_state(source, template.mesh,
                                   template.shard_dims)
        dp = axis(template.mesh, "dp")
        gens = raw.get("dp_generators")
        if gens is not None and gens.shape[0] == dp.size:
            source.generator = gens[dp.index].clone()
    return load_train_state(template, source)


def convert_and_save(torch_path: str, out_path: str,
                     cfg=None) -> Dict[str, Any]:
    """One-shot offline conversion: an upstream ``pytorch_model_*.bin``
    (checked against ``cfg``, default ``ViLBertConfig()``) saved as a
    checkpoint directory."""
    from vilbert_multitask_tpu_torch.config import ViLBertConfig

    params = load_torch_checkpoint(torch_path, cfg or ViLBertConfig())
    save_params(out_path, params)
    return params

