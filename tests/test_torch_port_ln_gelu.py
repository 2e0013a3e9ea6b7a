"""The speech encoder's feature-encoder norm (``ops/ln_gelu.py``) and its
route to the ``sdt::ln_gelu`` op, on the CPU.

``SpeechEncoder.forward`` runs each feature-encoder layer's bias, LayerNorm
and GELU as the op after a convolution without its bias, in a forward that
takes no gradient on the card's route; meta tensors stand for the card's here
(the op's fake gives their shape). The CPU, train mode, autograd and
``plain`` keep the plain composition (the convolution with its bias,
``F.layer_norm``, ``F.gelu``), bit for bit as before the kernel. The kernel's
arithmetic against the plain version is held on the card
(``tests/test_torch_port_gpu.py``).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from speechdrivestemplates_tpu_torch import kernels
from speechdrivestemplates_tpu_torch.models import speech_encoder as SE
from speechdrivestemplates_tpu_torch.ops import ln_gelu as LG

BF, F32 = torch.bfloat16, torch.float32
TINY = SE.SpeechEncoderSpec(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                            intermediate_size=128, conv_dim=(32,) * 7,
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
SAMPLES = 6400  # 19 encoder frames
EPS = TINY.layer_norm_eps
# LayerNorms a tiny forward runs: the feature encoder's 7, the projection's,
# two a transformer layer, the final one; GELUs: 7, the positional conv's, one
# a layer
LAYER_NORMS, GELUS = 7 + 1 + 2 * TINY.num_hidden_layers + 1, 7 + 1 + TINY.num_hidden_layers


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several test files at once on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class OpLog(TorchDispatchMode):
    """The ops dispatched while it is on; a convolution (``aten.convolution``,
    or ``aten.conv2d`` where inference mode keeps it whole) as ``conv+bias``
    or ``conv-bias``, a LayerNorm (``aten.native_layer_norm``, or
    ``aten.layer_norm``) as ``layer_norm``."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in ("aten.convolution", "aten.conv2d"):
            name = "conv-bias" if args[2] is None else "conv+bias"
        elif name in ("aten.native_layer_norm", "aten.layer_norm"):
            name = "layer_norm"
        self.ops.append(name)
        return func(*args, **(kwargs or {}))


def _encoder(dtype, seed=0):
    """The tiny encoder with its feature encoder's biases and LayerNorms moved
    off HuBERT's (0, 1, 0), so that a dropped or doubled one shows."""
    enc = SE.SpeechEncoder(TINY, dtype, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in enc.feature_extractor.conv_layers:
            m.conv.bias.copy_(0.1 * torch.randn(m.conv.bias.shape, generator=g))
            m.layer_norm.weight.copy_(1 + 0.1 * torch.randn(m.layer_norm.weight.shape,
                                                            generator=g))
            m.layer_norm.bias.copy_(0.1 * torch.randn(m.layer_norm.bias.shape, generator=g))
    return enc


def _audio(seed=2, n=2):
    return torch.randn(n, SAMPLES, generator=torch.Generator().manual_seed(seed))


def _layer_inputs(enc, audio):
    """Each feature-encoder layer's convolution input (B, C, 1, T), and its
    cached (weight, bias, LayerNorm weight, beta), by the plain composition."""
    x, out = audio.to(enc.dtype)[:, :, None], []
    with torch.no_grad():
        for (w, b, g, beta), stride in zip(enc._weights()[0], TINY.conv_stride):
            xi = x.transpose(1, 2).unsqueeze(2)
            out.append((xi, (w, b, g, beta), stride))
            y = F.conv2d(xi, w, b, stride=(1, stride)).squeeze(2).transpose(1, 2)
            x = F.gelu(F.layer_norm(y, (y.shape[-1],), g, beta, EPS))
    return out


def _composition_forward(enc, audio):
    """``SpeechEncoder.forward`` as it was before the kernel: every feature
    layer the convolution with its bias, ``F.layer_norm``, ``F.gelu``."""
    spec = enc.spec
    convs, (pln_w, pln_b, proj_w, proj_b), (pos_w, pos_b), layers, (ln_w, ln_b), _ = \
        enc.weights()
    eps, h = spec.layer_norm_eps, spec.hidden_size
    x = audio.to(enc.dtype)[:, :, None]
    for (w, b, g, beta), stride in zip(convs, spec.conv_stride):
        y = F.conv2d(x.transpose(1, 2).unsqueeze(2), w, b, stride=(1, stride))
        y = y.squeeze(2).transpose(1, 2)
        x = F.gelu(F.layer_norm(y, (y.shape[-1],), g, beta, eps))
    x = F.linear(F.layer_norm(x, (x.shape[-1],), pln_w, pln_b, eps), proj_w, proj_b)
    n, t = x.shape[:2]
    pos = SE.pos_conv(x, pos_w, spec.num_conv_pos_embedding_groups) + pos_b
    x = x + F.gelu(pos.to(enc.dtype))
    heads = spec.num_attention_heads
    for (a_w, a_b, qkv_w, qkv_b, o_w, o_b, f_w, f_b, w1, b1, w2, b2) in layers:
        qkv = F.linear(F.layer_norm(x, (h,), a_w, a_b, eps), qkv_w, qkv_b)
        q, k, v = qkv.view(n, t, 3, heads, h // heads).permute(2, 0, 3, 1, 4)
        a = SE.attention(q, k, v).transpose(1, 2).reshape(n, t, h)
        x = x + F.linear(a, o_w, o_b)
        y = F.layer_norm(x, (h,), f_w, f_b, eps)
        x = x + F.linear(F.gelu(F.linear(y, w1, b1)), w2, b2)
    return F.layer_norm(x, (h,), ln_w, ln_b, eps)


@pytest.mark.parametrize("layer", [0, 1, 6])
def test_the_plain_path_is_the_composition_in_fp32(layer):
    """In fp32, ``ln_gelu_plain`` of the convolution without its bias is the
    convolution with its bias, ``F.layer_norm`` and ``F.gelu``, bit for bit, at
    the first layer (C_in = 1), a middle one and the last."""
    enc = _encoder(F32)
    xi, (w, b, g, beta), stride = _layer_inputs(enc, _audio())[layer]
    with torch.no_grad():
        y = F.conv2d(xi, w, stride=(1, stride)).squeeze(2).transpose(1, 2)
        want = F.conv2d(xi, w, b, stride=(1, stride)).squeeze(2).transpose(1, 2)
        want = F.gelu(F.layer_norm(want, (want.shape[-1],), g, beta, EPS))
        got = LG.ln_gelu_plain(y, b, g, beta, EPS)
    assert got.dtype == F32 and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("layer", [0, 1, 6])
def test_the_plain_path_in_bf16_rounds_once_and_no_worse(layer):
    """In bf16, ``ln_gelu_plain`` is the same composition taken in fp32 on the
    bf16 convolution output and parameters, rounded once to bf16, bit for
    bit. The plain composition in bf16 rounds the biased output and the
    LayerNorm's to bf16 on the way: against the fp32 composition of the same
    bf16 operands it is no closer than the one rounding (rel L2), and the two
    lie within 4 bf16 ulps plus 1e-2 of each other (those two roundings,
    amplified by 1 / std where a row's mean is large)."""
    enc = _encoder(BF)
    xi, (w, b, g, beta), stride = _layer_inputs(enc, _audio())[layer]
    with torch.no_grad():
        y = F.conv2d(xi, w, stride=(1, stride)).squeeze(2).transpose(1, 2)
        got = LG.ln_gelu_plain(y, b, g, beta, EPS)
        v = y.float() + b.float()
        exact = F.gelu(F.layer_norm(v, (v.shape[-1],), g.float(), beta.float(), EPS))
        yb = F.conv2d(xi, w, b, stride=(1, stride)).squeeze(2).transpose(1, 2)
        composed = F.gelu(F.layer_norm(yb, (yb.shape[-1],), g, beta, EPS))
    assert got.dtype == BF and torch.equal(got, exact.to(BF))
    rel = [float((t.float() - exact).norm() / exact.norm()) for t in (got, composed)]
    assert rel[0] <= rel[1], rel
    ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - 8)
    assert ((got.float() - composed.float()).abs() <= 4 * ulp + 1e-2).all()


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """A tensor that requires grad (the kernel has no backward), a CPU tensor,
    a dtype or a rank the kernel does not take, parameters of another shape or
    dtype, C not a multiple of 8 or above 1,024, and rows that are not dense
    or not at a 16-byte boundary are refused before any launch."""
    def params(c, dtype=BF, device="meta"):
        return [torch.empty(c, dtype=dtype, device=device) for _ in range(3)]

    kernels.reset_launch_counts()
    x = torch.zeros(2, 5, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward"):
        LG.ln_gelu_kernel(x, *params(32, F32, "cpu"), EPS)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA"):
            LG.ln_gelu_kernel(x, *params(32, F32, "cpu"), EPS)
        for dtype in (torch.float16, torch.float64):
            with pytest.raises(ValueError, match="fp32 or bf16"):
                LG.ln_gelu_kernel(torch.empty(2, 5, 32, dtype=dtype, device="meta"),
                                  *params(32, dtype), EPS)
        for bad_x, bad_p in ((torch.empty(32, dtype=BF, device="meta"), params(32)),
                             (torch.empty(2, 5, 32, dtype=BF, device="meta"), params(64)),
                             (torch.empty(2, 5, 32, dtype=BF, device="meta"), params(32, F32))):
            with pytest.raises(ValueError, match="fp32 or bf16"):
                LG.ln_gelu_kernel(bad_x, *bad_p, EPS)
        for c in (4, 12, 36, 1032, 2048):
            with pytest.raises(ValueError, match="multiple of 8"):
                LG.ln_gelu_kernel(torch.empty(2, 5, c, dtype=BF, device="meta"), *params(c),
                                  EPS)
        base = torch.empty(2, 16, 5, dtype=BF, device="meta")
        for bad in (base.transpose(1, 2),  # (2, 5, 16) with channels strided
                    torch.empty(2, 5, 48, dtype=BF, device="meta")[..., :16],
                    torch.empty(2 * 5 * 16 + 1, dtype=BF, device="meta")[1:].view(2, 5, 16)):
            with pytest.raises(ValueError, match="dense rows at a 16-byte boundary"):
                LG.ln_gelu_kernel(bad, *params(16), EPS)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("grad_ctx", [torch.no_grad, torch.inference_mode])
@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
def test_eval_without_grad_on_the_cards_route_takes_the_op_seven_times(dtype, grad_ctx):
    """In eval mode with no gradient asked for, the encoder on meta tensors
    (the card's route) calls ``sdt.ln_gelu`` once a feature layer, right after
    a convolution without its bias, and runs no LayerNorm or GELU of its own
    there (those left: the projection's and the transformer's); its output
    has the CPU forward's shape and dtype."""
    enc = _encoder(dtype).eval()
    with torch.no_grad():
        want = enc(_audio())
    enc = enc.to("meta")
    kernels.reset_launch_counts()
    log = OpLog()
    with grad_ctx(), log:
        got = enc(torch.empty(2, SAMPLES, device="meta"))
    calls = [i for i, op in enumerate(log.ops) if op == "sdt.ln_gelu"]
    assert len(calls) == 7
    for i in calls:
        conv = max(j for j in range(i) if log.ops[j].startswith("conv"))
        assert log.ops[conv] == "conv-bias", log.ops[conv:i + 1]
        assert not {"layer_norm", "aten.gelu", "aten.add"} & set(log.ops[conv:i])
    assert log.ops[:calls[-1]].count("layer_norm") == 0
    assert log.ops.count("layer_norm") == LAYER_NORMS - 7
    assert log.ops.count("aten.gelu") == GELUS - 7
    assert not kernels.LAUNCHES
    assert (got.device.type, tuple(got.shape), got.dtype) == \
        ("meta", tuple(want.shape), want.dtype) == ("meta", (2, 19, 64), dtype)


@pytest.mark.parametrize("case", ["cpu", "train", "autograd", "plain"])
def test_the_plain_composition_is_kept_elsewhere(case):
    """On the CPU (eval, no gradient), in train mode, under autograd and with
    ``plain``, every feature layer runs the convolution with its bias,
    ``F.layer_norm`` and ``F.gelu``, and ``sdt.ln_gelu`` never; a gradient is
    there to take where autograd is on."""
    enc = _encoder(F32).train(case == "train")
    dev = "cpu" if case == "cpu" else "meta"
    enc = enc.to(dev)
    audio = _audio() if dev == "cpu" else torch.empty(2, SAMPLES, device=dev)
    grad_ctx = torch.enable_grad if case in ("train", "autograd") else torch.no_grad
    kernels.reset_launch_counts()
    log = OpLog()
    with grad_ctx(), log:
        out = enc(audio, plain=case == "plain")
    assert "sdt.ln_gelu" not in log.ops
    convs = [op for op in log.ops if op.startswith("conv")]
    assert convs == ["conv+bias"] * 7, convs
    assert log.ops.count("layer_norm") == LAYER_NORMS
    assert log.ops.count("aten.gelu") == GELUS
    assert out.requires_grad == (grad_ctx is torch.enable_grad)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("dtype", [F32, BF], ids=["fp32", "bf16"])
def test_a_tiny_encoders_cpu_output_is_unchanged_bit_for_bit(dtype, mode):
    """The tiny encoder's CPU forward (eval without a gradient, through the
    cached weights; train mode under autograd) is the forward as it was before
    the kernel (``_composition_forward``), bit for bit, in fp32 and bf16; and
    its ``plain`` forward is the same."""
    enc = _encoder(dtype, seed=5).train(mode == "train")
    audio = _audio(seed=6, n=3)
    ctx = torch.enable_grad if mode == "train" else torch.no_grad
    with ctx():
        got = enc(audio)
        plain = enc(audio, plain=True)
        want = _composition_forward(enc, audio)
    assert got.dtype == dtype and got.shape == (3, 19, 64)
    assert torch.equal(got.detach(), want.detach()) and torch.equal(plain.detach(),
                                                                    want.detach())
