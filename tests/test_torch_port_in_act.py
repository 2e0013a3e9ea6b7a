"""The route of eval-mode IN + lrelu + cast to the ``sdt::in_act`` op, on the CPU.

``ConvNormRelu`` with ``norm='IN'`` takes the op in eval mode on a card's
tensor, unless ``plain`` asks for the plain path; meta tensors stand for the
card's here (the op's fake gives their shape). Train mode, ``plain`` and the
CPU keep the plain path, which the JAX-parity tests hold; under autograd the
op's route raises, as the IN stem's does. BN layers (s2g's) keep ``sdt::bn_act``.
The kernel's arithmetic against the plain path is held on the card
(``tests/test_torch_port_gpu.py``).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from speechdrivestemplates_tpu_torch import kernels
from speechdrivestemplates_tpu_torch.kernels.ops import in_act_slab
from speechdrivestemplates_tpu_torch.models.blocks import (ConvNormRelu, channel_norm_1d,
                                                           conv_norm_relu_2d)
from speechdrivestemplates_tpu_torch.ops import in_act

BF, F32 = torch.bfloat16, torch.float32

# (conv type, c_in, c_out, extra arguments, input shape): SDT-BP's IN layers after the
# stem at a small size: layer 3 (k4 s2 from the stem's 128 channels), layer 5, the (6, 3)
# VALID conv (layer 7), the UNet's e0 (256 + 32 code channels), e6 (T = 2) and a
# 64-frame decoder layer
LAYERS = {
    "enc3": ("2d", 128, 128, dict(downsample=True), (2, 128, 8, 12)),
    "enc5": ("2d", 256, 256, dict(downsample=True), (2, 256, 6, 10)),
    "enc7": ("2d", 256, 256, dict(kernel_size=(6, 3), stride=1, padding=0), (2, 256, 10, 53)),
    "e0": ("1d", 288, 256, {}, (2, 288, 64)),
    "e6": ("1d", 256, 256, dict(downsample=True), (2, 256, 4)),
    "dec": ("1d", 256, 256, {}, (2, 256, 64)),
}


class OpLog(TorchDispatchMode):
    """The names of the ops dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _layer(name, dtype, seed=0, norm="IN"):
    conv_type, c_in, c_out, kw, shape = LAYERS[name]
    layer = ConvNormRelu(conv_type, c_in, c_out, norm=norm, dtype=dtype,
                         generator=torch.Generator().manual_seed(seed), **kw)
    return layer, shape


def _run(layer, x, grad_ctx, plain=False):
    log = OpLog()
    with grad_ctx(), log:
        out = layer(x, plain)
    return out, log.ops


@pytest.mark.parametrize("grad_ctx", [torch.no_grad, torch.inference_mode])
@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_eval_mode_without_grad_takes_the_op(name, dtype, grad_ctx):
    """In eval mode with no gradient asked for, an IN layer on a meta tensor
    calls ``sdt.in_act`` once after its convolution, and no separate
    statistics, norm, lrelu or cast; its output has the plain path's shape and
    dtype (the same layer on the CPU)."""
    layer, shape = _layer(name, dtype)
    layer.eval()
    with torch.no_grad():
        want = layer(torch.randn(shape))
    kernels.reset_launch_counts()
    got, ops = _run(layer.to("meta"), torch.empty(shape, device="meta"), grad_ctx)
    conv = max(i for i, op in enumerate(ops) if "conv" in op)
    assert ops[conv + 1:] == ["sdt.in_act"], ops
    assert not {"aten.var_mean", "aten.leaky_relu", "aten.rsqrt", "aten.sub"} & set(ops), ops
    assert got.device.type == "meta" and not kernels.LAUNCHES
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype) == \
        (tuple(want.shape), dtype)


@pytest.mark.parametrize("case", ["train", "plain", "cpu"])
@pytest.mark.parametrize("name", ["enc3", "e6"])
def test_the_plain_path_is_kept_elsewhere(name, case):
    """Train mode, an eval forward asked for its ``plain`` path and a CPU
    tensor run the plain path, op for op, under autograd as without it: no
    ``sdt.in_act``, and a gradient to take; on the CPU the eval output is the
    plain reference's (``conv_norm_relu_2d``, or the convolution,
    ``channel_norm_1d``, lrelu and cast), bit for bit."""
    layer, shape = _layer(name, F32)
    layer.train(case == "train")
    dev = "cpu" if case == "cpu" else "meta"
    layer = layer.to(dev)
    x = torch.randn(shape) if dev == "cpu" else torch.empty(shape, device=dev)
    kernels.reset_launch_counts()
    for grad_ctx in (torch.no_grad, torch.enable_grad):
        got, ops = _run(layer, x, grad_ctx, plain=case == "plain")
        assert "sdt.in_act" not in ops and "aten.leaky_relu" in ops, ops
        assert got.requires_grad == (grad_ctx is torch.enable_grad)
    assert not kernels.LAUNCHES
    if case == "cpu":
        c = layer.conv
        with torch.no_grad():
            if c.weight.ndim == 4:
                want = conv_norm_relu_2d(x, c.weight, c.stride, c.padding, layer.slope, F32)
            else:
                y = F.conv1d(x, c.weight, stride=c.stride, padding=c.padding)
                want = F.leaky_relu(channel_norm_1d(y), layer.slope).to(F32)
        assert torch.equal(got.detach(), want)


@pytest.mark.parametrize("dtype", [F32, BF, torch.float64], ids=["fp32", "bf16", "fp64"])
@pytest.mark.parametrize("name", ["enc7", "dec"])
def test_the_cpu_eval_route_is_the_plain_reference_bit_for_bit(name, dtype):
    """On the CPU an eval-mode IN layer (``in_act``'s plain version) gives
    what the plain reference gives, in each compute dtype: the statistics in
    fp32 (float64 for float64), lrelu, the cast back."""
    layer, shape = _layer(name, dtype, seed=3)
    layer.eval()
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4)).to(dtype)
    c = layer.conv
    with torch.no_grad():
        got = layer(x)
        if c.weight.ndim == 4:
            want = conv_norm_relu_2d(x, c.weight, c.stride, c.padding, layer.slope, dtype)
        else:
            y = F.conv1d(x, c.weight.to(dtype), stride=c.stride, padding=c.padding)
            want = F.leaky_relu(channel_norm_1d(y), layer.slope).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)


def test_bn_layers_never_take_the_op():
    """s2g's layers carry a BN module: in eval mode on the card's route they
    take ``sdt.bn_act`` and never ``sdt.in_act``, in 2-D and in 1-D."""
    for name in ("enc5", "dec"):
        layer, shape = _layer(name, BF, norm="BN")
        layer = layer.eval().to("meta")
        _, ops = _run(layer, torch.empty(shape, device="meta"), torch.no_grad)
        assert ops.count("sdt.bn_act") == 1 and "sdt.in_act" not in ops, ops


@pytest.mark.parametrize("name", ["enc3", "e6"])
def test_the_ops_route_under_autograd_raises(name):
    """In eval mode on the card's route with a gradient asked for, the layer
    raises before any launch (the op has no backward), as the IN stem does;
    ``plain`` is the route to train through."""
    layer, shape = _layer(name, F32)
    layer = layer.eval().to("meta")
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="has no backward"):
        _run(layer, torch.empty(shape, device="meta"), torch.enable_grad)
    assert not kernels.LAUNCHES


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """A tensor that requires grad (the kernel has no backward), a CPU tensor,
    a dtype or a rank the kernel does not take, and a layout that is neither
    channels-last nor contiguous are refused before any launch."""
    kernels.reset_launch_counts()
    y = torch.zeros(2, 256, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        in_act.in_act_kernel(y, 0.2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            in_act.in_act_kernel(y, 0.2)
        for bad in (torch.empty(2, 256, 2, dtype=torch.float16, device="meta"),
                    torch.empty(2, 256, 2, dtype=torch.float64, device="meta"),
                    torch.empty(2, 256, device="meta"),
                    torch.empty(2, 3, 256, 4, 4, device="meta")):
            with pytest.raises(ValueError, match="fp32 or bf16"):
                in_act.in_act_kernel(bad, 0.2)
        for bad in (torch.empty(2, 64, 256, device="meta").transpose(1, 2),
                    torch.empty(2, 256, 10, 106, device="meta")[..., :53],
                    torch.empty(2, 10, 256, 53, device="meta").transpose(1, 2)):
            with pytest.raises(ValueError, match="channels-last or contiguous"):
                in_act.in_act_kernel(bad, 0.2)
            with pytest.raises(ValueError, match="channels-last or contiguous"):
                in_act.in_act_kernel_stats(bad, 0.2)
        with pytest.raises(ValueError, match="2\\^31"):
            in_act.in_act_kernel(torch.empty(1, 1 << 16, 1 << 15, device="meta"), 0.2)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("shape, slab", [
    ((4, 128, 20, 106), (4 * 128, 2120, 1)),
    ((4, 256, 5, 51), (4 * 256, 255, 1)),
    ((4, 256, 64), (4, 256, 64)),
    ((1, 256, 2), (1, 256, 2))])
def test_the_slab_of_each_layout(shape, slab):
    """The kernel's (N, R, K) view: a channels-last plane as (B, H x W, C), a
    contiguous one as (B x C, H x W, 1), a (B, C, T) as itself."""
    x = torch.empty(shape)
    assert in_act_slab(x) == slab
    if x.ndim == 4:
        B, C, H, W = shape
        assert in_act_slab(x.contiguous(memory_format=torch.channels_last)) == (B, H * W, C)
        assert in_act_slab(x.permute(0, 1, 3, 2)) is None
    else:
        assert in_act_slab(x.transpose(1, 2).contiguous().transpose(1, 2)) is None


@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "strided"])
@pytest.mark.parametrize("shape", [(128, 256, 20, 106), (3, 256, 5, 51), (4, 256, 2)])
@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
def test_the_fake_gives_the_inputs_shape_and_strides(shape, dtype, layout):
    """On fake CUDA tensors, as ``torch.export`` traces the card's route, the
    op gives the activation's shape, strides and dtype (the dense layouts the
    kernel takes; another is made contiguous, as the implementation does),
    the statistics op (B, C) or (B, T) fp32 beside them, and nothing
    launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kernels.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(shape, dtype=dtype, device="cuda")
        if layout == "channels_last" and len(shape) == 4:
            B, C, H, W = shape
            x = torch.empty_strided(shape, (H * W * C, 1, W * C, C), dtype=dtype, device="cuda")
        elif layout == "strided":
            x = x.transpose(1, 2)
        out = torch.ops.sdt.in_act(x, 0.2)
        y, mean, var = torch.ops.sdt.in_act_stats(x, 0.2)
    assert out.device.type == "cuda"
    assert (tuple(out.shape), out.dtype) == (tuple(x.shape), dtype)
    want = x.stride() if layout != "strided" else torch.empty(x.shape).stride()
    assert out.stride() == y.stride() == want
    cols = x.shape[1] if x.ndim == 4 else x.shape[2]
    assert tuple(mean.shape) == tuple(var.shape) == (x.shape[0], cols)
    assert mean.dtype == var.dtype == F32
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("preset", ["sdt_bp", "s2g"])
def test_route_ops_counts_in_act_once_an_in_layer_after_the_stem(preset):
    """``route_ops``: SDT-BP's card route calls mel, conv1 and the stem once
    and in_act once for each of its 21 IN layers after the stem (audio
    encoder layers 3-7, the UNet's 12, the decoder's 4); s2g's is as it was,
    mel once and bn_act 24 times, with no in_act."""
    from speechdrivestemplates_tpu_torch import config
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.utils.export import route_ops

    model = build_model("SequenceGeneratorCNN", getattr(config, preset)(precision="bf16"),
                        device="cpu")
    want = {"sdt_bp": {"sdt.mel": 1, "sdt.conv1_in": 1, "sdt.stem": 1, "sdt.in_act": 21},
            "s2g": {"sdt.mel": 1, "sdt.bn_act": 24}}[preset]
    assert route_ops(model) == want


@pytest.mark.parametrize("grad_ctx", [torch.no_grad, torch.inference_mode])
def test_sdt_bp_generator_in_eval_mode_takes_the_op_21_times(grad_ctx):
    """SDT-BP's generator in eval mode on meta tensors: the stem's two ops and
    21 ``sdt.in_act``, and no ``aten.var_mean`` (the plain IN's statistics);
    in train mode and with ``plain``, no kernel op."""
    from speechdrivestemplates_tpu_torch import config
    from speechdrivestemplates_tpu_torch.models import build_model

    model = build_model("SequenceGeneratorCNN", config.sdt_bp(precision="bf16"),
                        device="cpu").to("meta")
    mel, code = torch.empty(2, 80, 427, device="meta"), torch.empty(2, 32, device="meta")
    for training, plain in ((False, False), (False, True), (True, False)):
        model.train(training)
        log = OpLog()
        with grad_ctx(), log:
            model(mel, 64, code, plain=plain)
        kernel_ops = {o: log.ops.count(o) for o in set(log.ops) if o.startswith("sdt.")}
        if training or plain:
            assert not kernel_ops and log.ops.count("aten.var_mean") == 24
        else:
            assert kernel_ops == {"sdt.conv1_in": 1, "sdt.stem": 1, "sdt.in_act": 21}
            assert "aten.var_mean" not in log.ops
