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

The training state's save and restore wait for the port's trainer.
"""

from __future__ import annotations

import os
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
                   cfg=None) -> Dict[str, Any]:
    """Restore a state dict on the host from a checkpoint directory
    (:func:`save_params`) or a torch file (an upstream ``.bin``), cast to
    ``dtype`` (:func:`cast_params`). With ``cfg`` (a ``ViLBertConfig``)
    the keys are checked against its model first. A checkpoint saved from
    an int8 engine restores unchanged: quantizing is idempotent."""
    if os.path.isdir(path):
        sd = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                        weights_only=True)
        if cfg is not None:
            check_keys(sd, cfg, path)
    elif cfg is not None:
        sd = load_torch_checkpoint(path, cfg)
    else:
        sd = read_torch_state_dict(path)
    return cast_params(sd, dtype)


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
                         cfg=None) -> AsyncRestore:
    """:func:`restore_params` on a background thread, so that reading and
    quantizing the checkpoint overlaps the rest of a boot."""
    box: dict = {}

    def _run() -> None:
        t0 = time.perf_counter()
        try:
            box["params"] = restore_params(path, dtype=dtype, cfg=cfg)
        except BaseException as e:  # noqa: BLE001 — joined and re-raised
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0

    thread = threading.Thread(target=_run, daemon=True,
                              name="checkpoint-restore")
    thread.start()
    return AsyncRestore(thread, box)


def convert_and_save(torch_path: str, out_path: str,
                     cfg=None) -> Dict[str, Any]:
    """One-shot offline conversion: an upstream ``pytorch_model_*.bin``
    (checked against ``cfg``, default ``ViLBertConfig()``) saved as a
    checkpoint directory."""
    from vilbert_multitask_tpu_torch.config import ViLBertConfig

    params = load_torch_checkpoint(torch_path, cfg or ViLBertConfig())
    save_params(out_path, params)
    return params

