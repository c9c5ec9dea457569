"""vilbert_multitask_tpu_torch — the PyTorch/CUDA port of
``vilbert_multitask_tpu`` for an NVIDIA H100 (sm_90a).

The JAX package beside it is the reference this port is held against, on the
same weights and inputs. This package imports neither JAX nor any module of
the JAX package; it keeps its own copies of what it needs (config, text,
features, decode, assets).

- ``models/``     two-stream ViLBERT trunk + 9 task heads as ``nn.Module``s,
                  in the upstream torch key layout.
- ``ops/``        attention primitives and the flash attention kernel's
                  wrapper and plain version; ``csrc/`` holds the CUDA source,
                  ``_build.py`` builds it with nvcc at first use.
- ``engine/``     the inference engine facade (prepare / run / decode /
                  predict) and per-task decode.
- ``checkpoint/`` JAX parameter tree → upstream torch state dict; the
                  port's own parameter and train-state checkpoints.
- ``train/``      the multi-task trainer: losses, the AdamW step, data,
                  the loop with snapshots and in-training evals.
- ``serve/``      the serving tier, and the remote worker (``remote.py``).
- ``text/``, ``features/``, ``assets/``: host-side copies.
"""

__version__ = "0.1.0"

from vilbert_multitask_tpu_torch.config import (  # noqa: F401
    EngineConfig,
    FrameworkConfig,
    ServingConfig,
    TASK_REGISTRY,
    TaskSpec,
    ViLBertConfig,
)
