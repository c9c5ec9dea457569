"""The middle of the detector's ResNeXt bottleneck: bn1 + ReLU, the grouped
3x3 convolution and bn2 + ReLU as one hand-written kernel, its launch plan
and its plain PyTorch version.

Counterpart of ``vilbert_multitask_tpu/detect/model.py:63-71`` (``conv1`` →
``bn1`` → ReLU → ``conv2`` with ``feature_group_count`` → ``bn2`` → ReLU),
which XLA fuses; here everything after ``conv1`` is one launch of
``csrc/grouped_conv.cu``:

- :func:`grouped_conv_bn_relu` takes conv1's raw output ``h``, conv2's
  weight, stride, padding and group count, and the two FrozenBN affines.
  CPU tensors, and a weight moved to channels-last (the TF32 extractor's
  layout, which ``FasterRCNN.memory_format`` reads the same way), take
  :func:`grouped_conv_bn_relu_plain`; every other call launches the
  kernel, and raises where the kernel cannot take it, as
  ``detect/model.py:roi_align`` does: a non-contiguous map, another dtype,
  a group width or stride with no instance, a call autograd would record.
  Kernel calls count in ``grouped_conv_bn_relu.launches``
  (``ops/routes.py``).
- :func:`grouped_conv_bn_relu_plain` is the composition the bottleneck
  ran before: ``F.relu(bn2(conv2(F.relu(bn1(h)))))``, op for op.
- :func:`launch` is the kernel alone: it raises on what the kernel does not
  take (:func:`check_launchable`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from vilbert_multitask_tpu_torch import _build
from vilbert_multitask_tpu_torch.ops import routes

BLOCK_CHANNELS = 64  # output channels a block of the kernel owns
# (group width, stride) pairs with an instance: the X-152's (its stride-2
# blocks open stages 3-5, whose widths are 16-64)
INSTANCES = ((8, 1), (16, 1), (16, 2), (32, 1), (32, 2), (64, 1), (64, 2))
_GRID_LIMIT = 65535  # the grid's y (channel blocks) and z (images)
_INT32_LIMIT = 2 ** 31 - 1  # the kernel's per-image indices

Pair = Union[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class GroupedConvPlan:
    """One launch of ``csrc/grouped_conv.cu``: the instance (group
    ``width``, ``stride``) and the output map's (H, W). The tile, its
    stages and shared memory are the kernel's own
    (:func:`shared_memory_bytes` asks it)."""

    width: int
    stride: int
    out_hw: Tuple[int, int]


def plan_launch(channels: int, groups: int, height: int, width: int,
                stride: int, batch: int = 1) -> Optional[GroupedConvPlan]:
    """The launch for ``batch`` maps of ``channels`` x ``height`` x
    ``width`` in ``groups`` groups (channels in = channels out, 3x3,
    padding 1) at ``stride``, or None where the kernel has no instance for
    the group width and stride (:data:`INSTANCES`, channels a multiple of
    :data:`BLOCK_CHANNELS`), or the shape passes its limits."""
    if groups < 1 or channels % groups:
        return None
    gw = channels // groups
    if ((gw, stride) not in INSTANCES or channels % BLOCK_CHANNELS
            or min(height, width) < 1
            or not 1 <= batch <= _GRID_LIMIT
            or channels // BLOCK_CHANNELS > _GRID_LIMIT
            or channels * height * width > _INT32_LIMIT):
        return None
    return GroupedConvPlan(width=gw, stride=stride,
                           out_hw=((height - 1) // stride + 1,
                                   (width - 1) // stride + 1))


def _pair(v) -> Optional[Tuple[int, int]]:
    """An int or a pair of ints as a pair; None for anything else (a
    padding mode such as ``"same"``)."""
    if isinstance(v, int):
        return v, v
    if isinstance(v, (tuple, list)) and len(v) == 2 and all(
            isinstance(x, int) for x in v):
        return tuple(v)
    return None


def check_launchable(h, weight, scale1, bias1, scale2, bias2, *,
                     stride: Pair, padding: Pair,
                     groups: int) -> GroupedConvPlan:
    """The kernel's launch for this call as it lies; raises ``ValueError``
    with the reason where it has none. Needs no card: :func:`launch`
    checks the device after this."""

    def refuse(why: str):
        return ValueError(f"grouped_conv kernel: {why}")

    if h.dim() != 4:
        raise refuse(f"h must be (N, C, H, W), got {tuple(h.shape)}")
    N, C, H, W = h.shape
    tensors = (h, weight, scale1, bias1, scale2, bias2)
    if any(t.dtype != torch.float32 for t in tensors):
        raise refuse(f"the kernel takes float32, got "
                     f"{sorted({str(t.dtype) for t in tensors})}")
    if any(t.device != h.device for t in tensors):
        raise refuse("h, the weight and the affines must share a device")
    if not h.is_contiguous():
        raise refuse("h must be contiguous NCHW (channels-last maps are "
                     "not)")
    if tuple(weight.shape[2:]) != (3, 3):
        raise refuse(f"the kernel is 3x3, got {tuple(weight.shape[2:])}")
    if _pair(padding) != (1, 1):
        raise refuse(f"the kernel pads by 1, got {padding}")
    sy, sx = _pair(stride) or (0, 0)
    if sy != sx or sy not in (1, 2):
        raise refuse(f"the kernel strides by 1 or 2, got {stride}")
    if groups < 1 or C % groups:
        raise refuse(f"{groups} groups do not divide {C} channels")
    if tuple(weight.shape) != (C, C // groups, 3, 3):
        raise refuse(f"the weight must be ({C}, {C // groups}, 3, 3) for "
                     f"{C} channels in {groups} groups, got "
                     f"{tuple(weight.shape)}")
    if not weight.is_contiguous():
        raise refuse("the weight must be contiguous")
    if any(tuple(t.shape) != (C,) or not t.is_contiguous()
           for t in (scale1, bias1, scale2, bias2)):
        raise refuse(f"the affines must be contiguous ({C},) vectors")
    plan = plan_launch(C, groups, H, W, sy, N)
    if plan is None:
        raise refuse(f"no instance for group width {C // groups} at "
                     f"stride {sy} (the kernel has (width, stride) "
                     f"{INSTANCES}, channels a multiple of "
                     f"{BLOCK_CHANNELS}) or a shape {tuple(h.shape)} past "
                     f"its limits")
    return plan


def grouped_conv_bn_relu_plain(h, weight, scale1, bias1, scale2, bias2, *,
                               stride: Pair, padding: Pair,
                               groups: int) -> torch.Tensor:
    """``relu(bn2(conv2(relu(bn1(h)))))`` in torch ops, as the bottleneck
    composed it: each FrozenBN a product and a sum, ``F.conv2d`` with no
    bias."""
    x = F.relu(h * scale1[:, None, None] + bias1[:, None, None])
    y = F.conv2d(x, weight, None, stride, padding, 1, groups)
    return F.relu(y * scale2[:, None, None] + bias2[:, None, None])


def _bind(lib: ctypes.CDLL):
    fn = lib.vmt_grouped_conv
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def shared_memory_bytes(width: int, stride: int,
                        lib: ctypes.CDLL = None) -> int:
    """Dynamic shared memory a block of the (group width, stride) instance
    asks for, bytes, as the built kernel states it; 0 where it has no
    instance. Builds the library (needs ``nvcc``)."""
    fn = (lib or _build.load("grouped_conv")).vmt_grouped_conv_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(width, stride)


def launch(h, weight, scale1, bias1, scale2, bias2, *, stride: Pair,
           padding: Pair, groups: int,
           lib: ctypes.CDLL = None) -> torch.Tensor:
    """Launch ``csrc/grouped_conv.cu`` on CUDA tensors on the current
    stream; raises ``ValueError`` where :func:`check_launchable` does or
    the tensors are not on a CUDA device. Counts nothing."""
    plan = check_launchable(h, weight, scale1, bias1, scale2, bias2,
                            stride=stride, padding=padding, groups=groups)
    if h.device.type != "cuda":
        raise ValueError(f"the grouped_conv kernel runs on CUDA tensors, "
                         f"got {h.device}")
    N, C, H, W = h.shape
    out = torch.empty((N, C, *plan.out_hw), dtype=torch.float32,
                      device=h.device)
    rc = _bind(lib or _build.load("grouped_conv"))(
        h.data_ptr(), weight.data_ptr(), scale1.data_ptr(), bias1.data_ptr(),
        scale2.data_ptr(), bias2.data_ptr(), out.data_ptr(), N, C, H, W,
        plan.width, plan.stride,
        torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_conv kernel launch failed: cudaError "
                           f"{rc}")
    return out


def lies_channels_last(weight: torch.Tensor) -> bool:
    """True where a convolution's 4-d weight was moved to channels-last
    (``module.to(memory_format=torch.channels_last)``: the TF32
    extractor's layout), from its strides alone."""
    return (weight.is_contiguous(memory_format=torch.channels_last)
            and not weight.is_contiguous())


@routes.kernel_wrapper("grouped_conv")
def grouped_conv_bn_relu(h, weight, scale1, bias1, scale2, bias2, *,
                         stride: Pair, padding: Pair,
                         groups: int) -> torch.Tensor:
    """``relu(bn2(conv2(relu(bn1(h)))))``: the composition for CPU tensors
    and channels-last weights, else the kernel, which raises where it
    cannot take the call (module docstring)."""
    args = (h, weight, scale1, bias1, scale2, bias2)
    kw = dict(stride=stride, padding=padding, groups=groups)
    if lies_channels_last(weight):
        return grouped_conv_bn_relu_plain(*args, **kw)
    return routes.launch_or_plain(
        "grouped_conv", args, lambda: grouped_conv_bn_relu_plain(*args, **kw),
        lambda: launch(*args, **kw))
