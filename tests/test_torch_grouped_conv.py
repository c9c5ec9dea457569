"""The bottleneck middle's kernel (``ops/grouped_conv.py``,
``csrc/grouped_conv.cu``): ``relu(bn2(conv2(relu(bn1(h)))))`` with conv2
the grouped 3x3 convolution.

On the CPU:
- the launch plan of every (group width, stride) the X-152 serves, and of
  the tiny configuration (its width-4 groups have no instance);
- the launch check refusing what the kernel does not take, and ``launch``
  refusing a contiguous f32 map with no instance;
- the plain version equal, bit for bit, to the composition the bottleneck
  ran before, a border where ``relu(bias1) != 0`` included;
- the route: CPU tensors and channels-last weights take the composition,
  counting no launch; tensors on any other device take the kernel's
  route, which raises rather than falling back (on ``meta`` tensors here).

On the card (``-m cuda``; they skip without one): the kernel at the seven
served shapes, a non-square map and maps whose sides are not multiples of
the tile, against the composition in float64, within twice the cuDNN f32
composition's own error; two launches bit-identical; one launch a call;
the route raising on a card map the kernel cannot take; a call captured
into a CUDA graph recorded, not counted; each instance's shared memory.
Run there with ``python -m pytest tests/test_torch_grouped_conv.py -m
cuda``.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from vilbert_multitask_tpu_torch.config import DetectorConfig
from vilbert_multitask_tpu_torch.detect import model as dm
from vilbert_multitask_tpu_torch.ops import grouped_conv as gc
from vilbert_multitask_tpu_torch.ops import routes

GROUPS = 32
# (channels, H, W of conv1's map, stride): every shape the X-152 serves on
# the 1344 canvas (stage 2 at 336, the stride-2 first blocks of stages 3-5)
SERVED = [(256, 336, 336, 1), (512, 336, 336, 2), (512, 168, 168, 1),
          (1024, 168, 168, 2), (1024, 84, 84, 1), (2048, 84, 84, 2),
          (2048, 42, 42, 1)]
# shapes no served call has: a non-square map, sides off the 8 x 28 tile
OTHER = [(256, 336, 252, 1), (1024, 37, 53, 1), (512, 45, 61, 2)]


def _inputs(channels: int, h: int, w: int, stride: int, *, seed: int = 0,
            device="cpu", groups: int = GROUPS):
    """conv1's raw output and the middle's weights as the detector draws
    them (lecun-normal conv2), with FrozenBN scales about 1 and biases of
    either sign, so relu(bias1) is not 0 where the halo pads."""
    g = torch.Generator().manual_seed(seed)
    width = channels // groups
    x = torch.randn((1, channels, h, w), generator=g)
    weight = torch.randn((channels, width, 3, 3), generator=g) / (
        9 * width) ** 0.5
    s1, s2 = (0.5 + torch.rand(channels, generator=g) for _ in range(2))
    b1, b2 = (torch.randn(channels, generator=g) * 0.5 for _ in range(2))
    ts = (x, weight, s1, b1, s2, b2)
    return tuple(t.to(device) for t in ts), dict(stride=stride, padding=1,
                                                  groups=groups)


# ----------------------------------------------------------- the plan (CPU)
@pytest.mark.parametrize("shape", SERVED, ids=lambda s: "x".join(map(str, s)))
def test_plan_of_each_served_shape(shape):
    c, h, w, stride = shape
    plan = gc.plan_launch(c, GROUPS, h, w, stride)
    width = c // GROUPS
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    assert plan == gc.GroupedConvPlan(width=width, stride=stride,
                                      out_hw=(ho, wo))
    assert (width, stride) in gc.INSTANCES and c % gc.BLOCK_CHANNELS == 0


def test_plan_of_the_tiny_config():
    cfg = DetectorConfig().tiny()
    widths = [cfg.width_per_group * 2 ** s for s in range(4)]
    assert widths == [4, 8, 16, 32]
    plans = [gc.plan_launch(cfg.groups * wd, cfg.groups, 16, 16,
                            1 if s == 0 else 2)
             for s, wd in enumerate(widths)]
    # width 4 has no instance; 2 groups of 8 or 16 are no 64-channel block;
    # 2 groups of 32 are one
    assert plans[:3] == [None, None, None]
    assert plans[3] == gc.GroupedConvPlan(width=32, stride=2, out_hw=(8, 8))


@pytest.mark.parametrize("c,groups,stride", [
    (256, 64, 1),   # width 4
    (96, 32, 1),    # width 3
    (256, 32, 3),   # stride 3
    (256, 32, 2),   # width 8 strides only by 1 (the X-152's stage 2)
    (256, 24, 1),   # 24 groups do not divide 256
    (32, 4, 1),     # width 8, but 32 channels are no 64-channel block
])
def test_plan_refuses_what_has_no_instance(c, groups, stride):
    assert gc.plan_launch(c, groups, 16, 16, stride) is None


_BAD = {
    "channels_last": lambda a, k: (
        (a[0].contiguous(memory_format=torch.channels_last),) + a[1:], k),
    "float64": lambda a, k: (tuple(t.double() for t in a), k),
    "bfloat16_h": lambda a, k: ((a[0].bfloat16(),) + a[1:], k),
    "not_3x3": lambda a, k: ((a[0], a[1][:, :, :1, :1].contiguous())
                             + a[2:], k),
    "padding_0": lambda a, k: (a, {**k, "padding": 0}),
    "padding_2": lambda a, k: (a, {**k, "padding": (2, 2)}),
    "padding_same": lambda a, k: (a, {**k, "padding": "same"}),
    "stride_3": lambda a, k: (a, {**k, "stride": 3}),
    "stride_1x2": lambda a, k: (a, {**k, "stride": (1, 2)}),
    "groups_not_dividing": lambda a, k: (a, {**k, "groups": 24}),
    "weight_not_contiguous": lambda a, k: (
        (a[0], a[1].transpose(2, 3)) + a[2:], k),
    "width_4": lambda a, k: (
        (a[0], torch.zeros(256, 4, 3, 3)) + a[2:], {**k, "groups": 64}),
    "batch_3d": lambda a, k: ((a[0][0],) + a[1:], k),
}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_launch_check_refuses_what_the_kernel_cannot_take(bad):
    args, kw = _BAD[bad](*_inputs(256, 12, 10, 1))
    with pytest.raises(ValueError, match="grouped_conv kernel"):
        gc.check_launchable(*args, **kw)


@pytest.mark.parametrize("stride", [1, 2])
def test_launch_check_accepts_the_served_layout(stride):
    # width 8 at stride 1 (stage 2), width 16 at stride 2 (stage 3's first)
    args, kw = _inputs(256 * stride, 12, 10, stride)
    plan = gc.check_launchable(*args, **kw)
    assert plan.out_hw == ((12 - 1) // stride + 1, (10 - 1) // stride + 1)


def test_launch_refuses_cpu_tensors():
    args, kw = _inputs(256, 12, 10, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gc.launch(*args, **kw)


@pytest.mark.parametrize("c,groups,stride", [
    (128, 32, 1),   # width 4: the tiny configuration's stage 2
    (256, 32, 2),   # width 8 at stride 2
    (32, 4, 1),     # width 8, but 32 channels are no 64-channel block
], ids=["width_4", "width_8_stride_2", "channels_32"])
def test_launch_refuses_a_contiguous_f32_map_with_no_instance(c, groups,
                                                              stride):
    args, kw = _inputs(c, 12, 10, stride, groups=groups)
    assert args[0].is_contiguous() and args[0].dtype == torch.float32
    with pytest.raises(ValueError, match="no instance"):
        gc.launch(*args, **kw)


def test_lies_channels_last_reads_the_weights_layout():
    block = dm.BottleneckX(256, 256, 32, 8)
    assert not gc.lies_channels_last(block.conv2.weight)
    block = block.to(memory_format=torch.channels_last)
    assert gc.lies_channels_last(block.conv2.weight)
    # a weight both layouts describe (1 x 1 taps, one channel a group)
    # lies NCHW
    assert not gc.lies_channels_last(torch.zeros(64, 1, 1, 1))


# ------------------------------------------------- the plain version (CPU)
def _block(c: int, width: int, stride: int, seed: int) -> dm.BottleneckX:
    """A BottleneckX whose middle carries :func:`_inputs`' weights."""
    block = dm.BottleneckX(c, c, c // width, width, stride=stride)
    (_, weight, s1, b1, s2, b2), _ = _inputs(c, 4, 4, stride, seed=seed,
                                             groups=c // width)
    with torch.no_grad():
        block.conv2.weight.copy_(weight)
        for bn, s, b in ((block.bn1, s1, b1), (block.bn2, s2, b2)):
            bn.scale.copy_(s)
            bn.bias.copy_(b)
    return block


def _old_middle(block: dm.BottleneckX, h: torch.Tensor) -> torch.Tensor:
    """The bottleneck's middle as its forward composed it before."""
    return F.relu(block.bn2(block.conv2(F.relu(block.bn1(h)))))


@pytest.mark.parametrize("c,width,stride,hw", [
    (256, 8, 1, (13, 11)), (512, 16, 2, (14, 9)), (64, 32, 2, (7, 8)),
    (8, 4, 1, (9, 9)),  # the tiny config's stage 2
], ids=["w8s1", "w16s2", "w32s2", "tiny_w4"])
def test_plain_is_the_old_composition_bit_for_bit(c, width, stride, hw):
    block = _block(c, width, stride, seed=c + stride)
    (h, *_), _ = _inputs(c, *hw, stride, seed=1, groups=c // width)
    c2 = block.conv2
    with torch.no_grad():
        got = gc.grouped_conv_bn_relu_plain(
            h, c2.weight, block.bn1.scale, block.bn1.bias, block.bn2.scale,
            block.bn2.bias, stride=c2.stride, padding=c2.padding,
            groups=c2.groups)
        want = _old_middle(block, h)
    assert torch.equal(got, want)
    # the halo is zero after the affine: relu(bias1) is not, somewhere
    assert (F.relu(block.bn1.bias) > 0).any()


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_block_forward_is_the_old_forward(layout):
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    block = _block(256, 8, 2, seed=3).to(memory_format=fmt)
    x = torch.randn(1, 256, 10, 12).contiguous(memory_format=fmt)
    with torch.no_grad():
        h = _old_middle(block, block.conv1(x))
        h = block.bn3(block.conv3(h))
        want = F.relu(h + block.downsample_bn(block.downsample(x)))
        assert torch.equal(block(x), want)


def test_cpu_calls_count_as_composition(monkeypatch):
    # every block's middle takes the composition on the CPU: the model's
    # output is the one with the plain version in the wrapper's place, and
    # no launch is counted
    cfg = DetectorConfig().tiny()
    model = dm.FasterRCNN(cfg)
    model.load_state_dict(dm.init_state_dict(cfg, seed=0))
    image = torch.zeros(cfg.canvas, cfg.canvas, 3)
    calls = []
    real = dm.grouped_conv_bn_relu
    monkeypatch.setattr(dm, "grouped_conv_bn_relu",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    before = gc.grouped_conv_bn_relu.launches
    with torch.inference_mode():
        got = model(image, (cfg.canvas, 40))
        monkeypatch.setattr(dm, "grouped_conv_bn_relu",
                            gc.grouped_conv_bn_relu_plain)
        want = model(image, (cfg.canvas, 40))
    assert len(calls) == sum(cfg.stage_blocks)
    assert gc.grouped_conv_bn_relu.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _meta(args, kw, *, grad: bool = False):
    args = tuple(t.to("meta") for t in args)
    if grad:
        args[1].requires_grad_(True)
    return args, kw


@pytest.mark.parametrize("case", [
    "served_layout", "no_instance", "not_contiguous", "needs_grad"])
def test_other_devices_take_the_kernel_route_and_raise(case):
    # only CPU tensors and channels-last weights fall back to the
    # composition; here the kernel's route refuses, counting nothing: the
    # shared route raises on a gradient and on a device other than CUDA,
    # and the kernel's own launch on the reason it would raise on the card
    args, kw = _inputs(128 if case == "no_instance" else 256, 12, 10, 1)
    args, kw = _meta(args, kw, grad=case == "needs_grad")
    if case == "not_contiguous":
        args = (args[0].contiguous(memory_format=torch.channels_last),
                ) + args[1:]
    before = gc.grouped_conv_bn_relu.launches
    want = {"served_layout": (ValueError, "CUDA tensors"),
            "no_instance": (ValueError, "no instance"),
            "not_contiguous": (ValueError, "contiguous NCHW"),
            "needs_grad": (RuntimeError, "no backward")}[case]
    route = want if case == "needs_grad" else (ValueError, "CUDA tensors")
    with pytest.raises(route[0], match=route[1]):
        gc.grouped_conv_bn_relu(*args, **kw)
    if case != "needs_grad":
        with pytest.raises(want[0], match=want[1]):
            gc.launch(*args, **kw)
    assert gc.grouped_conv_bn_relu.launches == before


def test_channels_last_weights_count_as_composition():
    # the composition on the CPU (bit for bit) and on any other device
    # (meta here, where the NCHW call raises above); no launch counted
    args, kw = _inputs(256, 12, 10, 1)
    weight = args[1].contiguous(memory_format=torch.channels_last)
    x = args[0].contiguous(memory_format=torch.channels_last)
    before = gc.grouped_conv_bn_relu.launches
    got = gc.grouped_conv_bn_relu(x, weight, *args[2:], **kw)
    assert torch.equal(got, gc.grouped_conv_bn_relu_plain(x, weight,
                                                          *args[2:], **kw))
    meta = tuple(t.to("meta") for t in (x, weight) + args[2:])
    assert gc.grouped_conv_bn_relu(*meta, **kw).shape == got.shape
    assert gc.grouped_conv_bn_relu.launches == before


# ------------------------------------------------------- the kernel (card)
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none here)")
    return torch.device("cuda")


def _f32_composition(args, kw):
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=False, allow_tf32=False):
        return gc.grouped_conv_bn_relu_plain(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SERVED + OTHER,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_against_float64(card, shape):
    args, kw = _inputs(*shape, seed=sum(shape), device=card)
    got = gc.launch(*args, **kw)
    again = gc.launch(*args, **kw)
    cudnn = _f32_composition(args, kw)
    want = gc.grouped_conv_bn_relu_plain(*(t.double() for t in args), **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, again)
    err = (got.double() - want).abs().max().item()
    cudnn_err = (cudnn.double() - want).abs().max().item()
    assert err <= 2 * cudnn_err, (err, cudnn_err)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_one_launch_a_call(card, stride):
    from torch.profiler import ProfilerActivity, profile

    args, kw = _inputs(1024, 84, 84, stride, device=card)
    gc.launch(*args, **kw)  # build and load first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        gc.grouped_conv_bn_relu(*args, **kw)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "grouped_conv_bn_relu_kernel" in kernels[0]


@pytest.mark.cuda
def test_shared_memory_of_each_instance(card):
    # two blocks an SM (228 KB, 1 KB of it reserved a block); no instance
    # asks for nothing
    for width in (4, 8, 16, 32, 64):
        for stride in (1, 2):
            got = gc.shared_memory_bytes(width, stride)
            if (width, stride) in gc.INSTANCES:
                assert 0 < got and 2 * (got + 1024) <= 228 * 1024
            else:
                assert got == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["channels_last_map", "width_4"])
def test_the_route_raises_on_a_card_map_the_kernel_cannot_take(card, case):
    if case == "width_4":
        args, kw = _inputs(128, 24, 20, 1, device=card)
    else:
        args, kw = _inputs(256, 24, 20, 1, device=card)
        args = (args[0].contiguous(memory_format=torch.channels_last),
                ) + args[1:]
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="grouped_conv kernel"):
        gc.grouped_conv_bn_relu(*args, **kw)


@pytest.mark.cuda
def test_a_captured_call_is_recorded_not_counted(card):
    args, kw = _inputs(512, 168, 168, 1, device=card)
    stream = torch.cuda.Stream()
    with torch.inference_mode():
        want = gc.launch(*args, **kw)
        torch.cuda.synchronize()
        before = gc.grouped_conv_bn_relu.launches
        graph = torch.cuda.CUDAGraph()
        with routes.recording() as recorded, torch.cuda.graph(
                graph, stream=stream):
            out = gc.grouped_conv_bn_relu(*args, **kw)
        assert recorded == {gc.grouped_conv_bn_relu: 1}
        assert gc.grouped_conv_bn_relu.launches == before
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want)
