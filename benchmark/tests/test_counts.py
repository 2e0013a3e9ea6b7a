"""The operation and byte counts against values worked by hand, and the
configurations' counts against the counting functions."""

import json
import math
import os

import pytest

from benchmark import counts
from benchmark.counts import conv1, generator, mel, stem

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
B, L, W = 128, 68267, 427  # the serving cells' batch, samples, mel frames


def test_b2_stem():
    # conv2 64->64 4x4 s2 and conv3 64->128 3x3 at (40, 213): 2 x 1,090,560 x 139,264
    flops, nbytes = stem.count(B, W)
    assert flops == 2 * (B * 40 * 213) * (64 * 64 * 16 + 128 * 64 * 9) == 303_751_495_680
    # in: 80 x 427 x 64 bf16 a clip; weights 139,264 bf16; out: 40 x 213 x 128 bf16
    assert nbytes == 559_677_440 + 278_528 + 279_183_360 == 839_139_328
    assert round(flops / 1e9, 1) == 303.8


def test_b3_conv1():
    flops, nbytes = conv1.count(B, W)
    assert flops == 2 * B * 80 * W * 64 * 9 == 5_037_096_960
    # mel fp32 in, 576 fp32 taps, 80 rows of 64 bf16 channels out (the kernel's two
    # zero rows, 591,161,600 bytes with them, are its layout's, not the function's)
    assert nbytes == 4 * B * 80 * W + 4 * 576 + 2 * B * 80 * W * 64 == 577_169_664


def test_b1_mel():
    flops, nbytes = mel.count(B, L)
    assert mel.frames(L) == W
    assert nbytes == 4 * (B * L + B * 80 * W) == 52_442_624
    per_frame = 2.5 * 512 * 9 + 400 + 3 * 257 + 2 * 257 * 80
    assert per_frame == 11_520 + 400 + 771 + 41_120 == 53_811
    assert flops == B * W * per_frame
    # bound by bytes: 15.65 us at 3.35 TB/s, far above the operations' 2.97 us
    assert math.isclose(counts.bound_s(flops, nbytes), nbytes / 3.35e12)


def test_generator_forward_by_hand():
    enc = [80 * 427 * 64 * 1 * 9, 40 * 213 * 64 * 64 * 16, 40 * 213 * 128 * 64 * 9,
           20 * 106 * 128 * 128 * 16, 20 * 106 * 256 * 128 * 9, 10 * 53 * 256 * 256 * 16,
           10 * 53 * 256 * 256 * 9, 5 * 51 * 256 * 256 * 18]
    unet = [64 * 256 * 288 * 3, 64 * 256 * 256 * 3] + [t * 256 * 256 * 4 for t in (32, 16, 8, 4, 2)] \
        + [t * 256 * 256 * 3 for t in (4, 8, 16, 32, 64)]
    dec = [64 * 256 * 256 * 3] * 4 + [64 * 242 * 256]
    assert generator.conv_macs(L, 64, 32, 121) == enc + unet + dec
    want = 2 * sum(enc + unet + dec) + W * 53_811
    assert generator.forward_flops(L, 64, 32, 121) == want == 7_378_965_265
    pose_enc = 64 * 256 * 242 * 3 + 64 * 256 * 256 * 3 + sum(t * 256 * 256 * 4 for t in (32, 16, 8, 4)) \
        + 2 * 64 * 256 * 4
    assert generator.pose_encoder_macs(64, 121) == pose_enc == 40_337_408
    macs = enc + unet + dec
    step = want + 2 * (2 * sum(macs) - macs[0]) + 4 * pose_enc
    assert generator.train_step_flops(68266, 64, 32, 121) == step


@pytest.mark.parametrize("name", ["sdt_bp", "s2g_gan"])
def test_configurations_carry_their_counts(name):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        conf = json.load(f)
    m, flops = conf["model"], conf["flops"]
    samples = int(m["num_frames"] * m["sample_rate"] / m["fps"])
    assert flops["forward_per_clip"] == generator.forward_flops(
        m["audio_length"], m["num_frames"], m["code_dim"], m["num_landmarks"])
    if "train_step_per_clip" in flops:
        assert flops["train_step_per_clip"] == generator.train_step_flops(
            samples, m["num_frames"], m["code_dim"], m["num_landmarks"])
