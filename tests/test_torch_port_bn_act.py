"""The route of eval-mode BN + lrelu + cast to the ``sdt::bn_act`` op, on the CPU.

``ConvNormRelu`` with ``norm='BN'`` takes the op in eval mode on a card's
tensor, unless ``plain`` asks for the plain path; meta tensors stand for the
card's here (the op's fake gives their shape). Train mode, ``plain`` and the
CPU keep the plain path, which the JAX-parity tests hold; under autograd the
op's route raises, as the IN stem's does. The kernel's arithmetic against the
plain path is held on the card (``tests/test_torch_port_gpu.py``).
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from speechdrivestemplates_tpu_torch import kernels
from speechdrivestemplates_tpu_torch.models.blocks import ConvNormRelu
from speechdrivestemplates_tpu_torch.ops import bn_act

BF, F32 = torch.bfloat16, torch.float32

# (conv type, c_in, c_out, extra arguments, input shape): s2g's BN layer shapes at a
# small size: layer 0 (C_in 1, a full plane), a 10 x 53 = 530 plane (layers 5-6), the
# (6, 3) VALID conv (layer 7), the UNet's T = 2 (e6) and a 64-frame decoder layer
LAYERS = {
    "enc0": ("2d", 1, 64, {}, (2, 1, 80, 9)),
    "enc5": ("2d", 256, 256, {}, (2, 256, 10, 53)),
    "enc7": ("2d", 256, 256, dict(kernel_size=(6, 3), stride=1, padding=0), (2, 256, 10, 53)),
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


def _layer(name, dtype, seed=0):
    conv_type, c_in, c_out, kw, shape = LAYERS[name]
    layer = ConvNormRelu(conv_type, c_in, c_out, norm="BN", dtype=dtype,
                         generator=torch.Generator().manual_seed(seed), **kw)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # statistics as the benchmark seeds them, near (1, 0, 0, 1)
        bn = layer.norm
        bn.weight.copy_(1 + 0.1 * torch.randn(c_out, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c_out, generator=g))
        bn.running_mean.copy_(0.1 * torch.randn(c_out, generator=g))
        bn.running_var.copy_(torch.exp(0.2 * torch.randn(c_out, generator=g)))
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
    """In eval mode with no gradient asked for, a BN layer on a meta tensor
    calls ``sdt.bn_act`` once after its convolution, and no separate norm,
    lrelu or cast; its output
    has the plain path's shape and dtype (the same layer on the CPU)."""
    layer, shape = _layer(name, dtype)
    layer.eval()
    with torch.no_grad():
        want = layer(torch.randn(shape))
    kernels.reset_launch_counts()
    got, ops = _run(layer.to("meta"), torch.empty(shape, device="meta"), grad_ctx)
    assert ops[-1] == "sdt.bn_act" and ops.count("sdt.bn_act") == 1, ops
    assert not {"aten.leaky_relu", "aten.rsqrt", "aten.sub", "aten.mul", "aten.add"} & set(ops)
    assert got.device.type == "meta" and not kernels.LAUNCHES
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype) == \
        (tuple(want.shape), dtype)


@pytest.mark.parametrize("case", ["train", "plain", "cpu"])
@pytest.mark.parametrize("name", ["enc0", "e6"])
def test_the_plain_path_is_kept_elsewhere(name, case):
    """Train mode (batch statistics), an eval forward asked for its ``plain``
    path and a CPU tensor run the plain path, op for op, under autograd as
    without it: no ``sdt.bn_act``, and a gradient to take; on the CPU the
    output is the BN module, lrelu and cast of the convolution, bit for bit."""
    layer, shape = _layer(name, F32)
    layer.train(case == "train")
    dev = "cpu" if case == "cpu" else "meta"
    layer = layer.to(dev)
    x = torch.randn(shape) if dev == "cpu" else torch.empty(shape, device=dev)
    kernels.reset_launch_counts()
    for grad_ctx in (torch.no_grad, torch.enable_grad):
        got, ops = _run(layer, x, grad_ctx, plain=case == "plain")
        assert "sdt.bn_act" not in ops and "aten.leaky_relu" in ops, ops
        assert got.requires_grad == (grad_ctx is torch.enable_grad)
    assert not kernels.LAUNCHES
    if case == "cpu":
        c = layer.conv
        conv = torch.nn.functional.conv2d if c.weight.ndim == 4 else torch.nn.functional.conv1d
        with torch.no_grad():
            y = conv(x, c.weight, stride=c.stride, padding=c.padding)
            assert torch.equal(got.detach(), bn_act.bn_act_plain(y, layer.norm, layer.slope))


@pytest.mark.parametrize("name", ["enc0", "e6"])
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
    a tensor whose channels or dtype the kernel does not take and statistics
    that are not fp32 are refused before any launch."""
    layer, _ = _layer("e6", F32)
    layer.eval()
    y = torch.zeros(2, 256, 2, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        bn_act.bn_act_kernel(y, layer.norm, 0.2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            bn_act.bn_act_kernel(y, layer.norm, 0.2)
        layer = layer.to("meta")
        with pytest.raises(ValueError, match="256"):
            bn_act.bn_act_kernel(torch.empty(2, 128, 2, device="meta"), layer.norm, 0.2)
        with pytest.raises(ValueError, match="bf16"):
            bn_act.bn_act_kernel(torch.empty(2, 256, 2, dtype=torch.float16, device="meta"),
                                 layer.norm, 0.2)
        with pytest.raises(ValueError, match="statistics torch.float64"):
            bn_act.bn_act_kernel(torch.empty(2, 256, 2, device="meta"), layer.norm.double(), 0.2)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("shape", [(128, 64, 80, 427), (3, 256, 5, 51), (4, 256, 2)])
@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
def test_the_fake_gives_the_inputs_shape_on_fake_cuda_tensors(shape, dtype):
    """On fake CUDA tensors, as ``torch.export`` traces the card's route, the
    op gives the activation's shape and dtype and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kernels.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(shape, dtype=dtype, device="cuda")
        vecs = [torch.empty(shape[1], device="cuda") for _ in range(4)]
        out = torch.ops.sdt.bn_act(x, *vecs, 0.2)
    assert out.device.type == "cuda"
    assert (tuple(out.shape), out.dtype) == (shape, dtype)
    assert not kernels.LAUNCHES


def test_s2g_serving_export_reads_each_bn_layers_vectors_as_inputs():
    """``torch.export`` of s2g's serving module on meta tensors (the card's
    route): the graph calls ``sdt.bn_act`` once for each of the 24 BN layers,
    and each call reads that layer's running mean and variance, weight and
    bias as the program's own buffers and parameters, so an artifact carries
    them."""
    from speechdrivestemplates_tpu_torch.config import s2g
    from speechdrivestemplates_tpu_torch.models import build_model
    from speechdrivestemplates_tpu_torch.serving import ServingModule
    from speechdrivestemplates_tpu_torch.utils.export import graph_ops

    cfg = s2g(precision="bf16")
    sd = build_model("SequenceGeneratorCNN", cfg, device="cpu").state_dict()
    module = ServingModule(cfg, sd, "cpu").to("meta")
    args = (torch.empty(2, 68267, device="meta"),)
    with torch.no_grad():
        program = torch.export.export(module, args)
    assert graph_ops(program) == {"sdt.bn_act": 24, "sdt.mel": 1}
    sig = program.graph_signature
    lifted = {**sig.inputs_to_buffers, **sig.inputs_to_parameters}
    layers = set()
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("sdt.bn_act"):
            names = [lifted[a.name] for a in node.args[1:5]]
            prefix = names[0][: -len("running_mean")]
            assert names == [prefix + k for k in ("running_mean", "running_var", "weight",
                                                  "bias")]
            layers.add(prefix)
    assert len(layers) == 24
    assert sum(1 for k in sd if k.endswith(".norm.running_mean")) == 24

