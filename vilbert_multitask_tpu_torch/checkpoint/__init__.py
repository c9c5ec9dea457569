"""Checkpoints: the JAX tree and upstream torch files carried into this
package's layout (convert.py), and the port's own checkpoint store
(store.py)."""

from vilbert_multitask_tpu_torch.checkpoint.convert import (
    build_name_map,
    from_flax_params,
    load_torch_checkpoint,
)
from vilbert_multitask_tpu_torch.checkpoint.store import (
    AsyncRestore,
    cast_params,
    convert_and_save,
    restore_params,
    restore_params_async,
    save_params,
)

__all__ = [
    "AsyncRestore",
    "build_name_map",
    "cast_params",
    "convert_and_save",
    "from_flax_params",
    "load_torch_checkpoint",
    "restore_params",
    "restore_params_async",
    "save_params",
]
