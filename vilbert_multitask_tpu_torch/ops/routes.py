"""The hand-written kernels: which library each is, which variant builds
it, and the one route every kernel's wrapper takes.

:data:`LIBRARIES` declares each ``csrc/<name>.cu`` once: the wrapper that
launches and counts it (``<module>.<function>`` under the package) and the
variant that needs it (``every`` served variant, ``flash`` when the
hand-written attention is selected, ``int8`` storage, ``live_extract``).
``engine/aotcache.py`` and ``engine/prewarm.py`` read their library lists
from it, and ``engine/graphs.py`` the wrappers it counts
(:func:`wrappers`); each wrapper attaches itself where it is defined
(:func:`kernel_wrapper`), so this module imports none of them.

Every wrapper ends in :func:`launch_or_plain`: the tensors on one device;
CPU tensors take the plain version, whose torch ops autograd follows;
on any other device a tensor that needs a gradient raises
(:func:`refuse_gradient`: the kernels compute the forward only), a device
other than CUDA raises, and the kernel launches and is counted
(:func:`count`).

The model's sites route a call by :func:`records_gradient`
(``ops/layer_norm.py:layer_norm``, ``ops/softmax.py:attention_probs``,
the dense core's gate in ``ops/attention.py:cross_attention``): a call
that autograd records (gradients enabled and an input or a parameter
requiring grad: the trainer's step) takes a torch composition, any other
the wrapper. Flash attention has no such site: training turns it off
(``use_pallas_*=False``).

A wrapper counts in Python, which the replay of a CUDA graph does not
run: a call made while its thread's current stream captures adds to the
thread-local ``recorded`` tally (:func:`recording` reads it), any other
to ``<wrapper>.launches``, and each replay adds what its capture recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, TypeVar

import torch

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class Library:
    name: str  # csrc/<name>.cu
    entry: str  # the counted wrapper, <module>.<function> under the package
    variant: str  # every | flash | int8 | live_extract


LIBRARIES = (
    Library("flash_attn", "ops.coattention.flash_cross_attention", "flash"),
    Library("layer_norm", "ops.layer_norm.add_layer_norm", "every"),
    Library("softmax", "ops.softmax.scaled_masked_softmax", "every"),
    Library("dense_attention", "ops.dense_attention.dense_attention",
            "every"),
    Library("int8_linear", "ops.int8_linear.int8_linear", "int8"),
    Library("nms", "ops.nms.nms_mask", "live_extract"),
    Library("roi_align", "detect.model.roi_align", "live_extract"),
    Library("grouped_conv", "ops.grouped_conv.grouped_conv_bn_relu",
            "live_extract"),
)
_WRAPPERS: Dict[str, Callable] = {}  # library → wrapper, once imported


def kernel_wrapper(library: str) -> Callable[[T], T]:
    """Declare the decorated function the wrapper of ``library``: it gets
    ``launches`` (kernel launches since the last reset; callers zero and
    read it) and its ``recorded`` tally."""

    def attach(wrapper):
        wrapper.launches = 0
        wrapper.recorded = threading.local()
        _WRAPPERS[library] = wrapper
        return wrapper
    return attach


def wrappers() -> tuple:
    """The declared wrappers whose modules are imported, in
    :data:`LIBRARIES` order (a wrapper never imported was never called)."""
    return tuple(_WRAPPERS[lib.name] for lib in LIBRARIES
                 if lib.name in _WRAPPERS)


def records_gradient(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd records a call on ``tensors`` (``None`` entries
    are skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_gradient(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when autograd would need a gradient through
    ``kernel``, which has none: its output would carry no ``grad_fn``."""
    if records_gradient(*tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad with "
            f"gradients enabled. Call the kernel's wrapper under "
            f"torch.no_grad(); a recorded call takes the plain version "
            f"(ops/routes.py), and flash attention trains with "
            f"use_pallas_coattention=False and use_pallas_self_attention"
            f"=False")


def count(wrapper: Callable) -> None:
    """Count one kernel launch of ``wrapper``: into this thread's
    ``recorded`` tally while its current stream captures, else into
    ``launches``."""
    if torch.cuda.is_current_stream_capturing():
        rec = wrapper.recorded
        rec.n = getattr(rec, "n", 0) + 1
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[Callable, int]]:
    """Zero this thread's recorded tallies; on a normal exit the yielded
    dict holds, per wrapper, the calls this thread recorded inside."""
    for w in wrappers():
        w.recorded.n = 0
    got: Dict[Callable, int] = {}
    yield got
    got.update({w: n for w in wrappers()
                if (n := getattr(w.recorded, "n", 0))})


def launch_or_plain(library: str, tensors: Sequence[Optional[torch.Tensor]],
                    plain: Callable[[], T], launch: Callable[[], T]) -> T:
    """The route of ``library``'s wrapper (module docstring): ``plain()``
    for CPU tensors, else ``launch()`` on CUDA tensors, counted; raises on
    tensors on several devices, on a gradient it would lose and on any
    other device. ``None`` entries of ``tensors`` are skipped."""
    wrapper = _WRAPPERS[library]
    name = wrapper.__name__
    tensors = [t for t in tensors if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices: {devices}")
    device = tensors[0].device
    if device.type == "cpu":
        return plain()
    refuse_gradient(name, *tensors)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device} (CUDA "
                         f"tensors launch it, CPU tensors take the plain "
                         f"version)")
    out = launch()
    count(wrapper)
    return out
