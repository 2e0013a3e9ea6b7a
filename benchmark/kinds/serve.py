"""Traffic kind ``serve``: closed loop, offline batches. ``batch`` clips of
``samples`` samples, ``buffers`` device-resident input sets (audio and, for a
code model, template codes) made from the seed, called back to back through
``serving.build_serving_fn``'s function; a seeded uniform sample of ``keep``
calls' outputs, and the last call's, are kept for the check."""

import time
from typing import List

import numpy as np
import torch

from .. import correct, drivers
from ..drivers import Reservoir, port_config
from ..weights import device_generator, seed_stream, seeded_weights, speech_like_audio


class Driver(drivers.Driver):
    def setup(self) -> None:
        from speechdrivestemplates_tpu_torch.serving import build_serving_fn

        self.build_kernels()
        t, m, dev = self.traffic, self.model, self.device
        self.cfg = port_config(self.conf, self.mm)
        self.weights = seeded_weights(self.mm, m, self.seed, dev)
        self.fn, has_code = build_serving_fn(self.cfg, self.mm.port_state_dict(self.weights), dev)
        gen = device_generator(self.seed, "inputs", dev)
        self.bufs = []
        for _ in range(t["buffers"]):
            audio = speech_like_audio(t["batch"], t["samples"], gen, dev)
            code = (torch.randn(t["batch"], m["code_dim"], generator=gen, device=dev)
                    if has_code else None)
            self.bufs.append((audio, code))
        for audio, code in self.bufs:
            self.fn(audio, code)
        self.sync()

    def window(self, seconds: float, win) -> dict:
        t = self.traffic
        sample = Reservoir(t["keep"], np.random.default_rng(seed_stream(self.seed, "keep")))
        n, i = len(self.bufs), 0
        win.start()
        end = win.t0 + int(seconds * 1e9)
        while True:
            audio, code = self.bufs[i % n]
            with self.spans.span("forward", i):
                out = self.fn(audio, code)
            sample.offer((i % n, out))
            i += 1
            if time.perf_counter_ns() >= end:
                break
        self.kept = sample.items + ([] if sample.items[-1][1] is out else [((i - 1) % n, out)])
        with self.spans.span("sync"):
            win.stop()
        frames = i * t["batch"] * self.model["num_frames"]
        self.work = {"calls": i, "clips": i * t["batch"], "batch": t["batch"],
                     "samples": t["samples"]}
        return {"serve_pose_frames_per_s": frames / win.seconds, "attempted": i}

    def free(self) -> None:
        self.fn = None

    def check(self, control: bool = False) -> List[tuple]:
        m = self.model
        refs = {}
        for b in sorted({b for b, _ in self.kept}):
            audio, code = self.bufs[b]
            refs[b] = self.mm.reference_poses(self.weights, audio, code, m, self.stat())
        if control:
            outs = {b: self.mm.reference_poses(self.weights, self.bufs[b][0], self.bufs[b][1], m,
                                               self.stat(), quant=correct.fp8) for b in refs}
            pairs = [(outs[b], refs[b]) for b in refs]
        else:
            pairs = [(out, refs[b]) for b, out in self.kept]
        return correct.pose_numbers(pairs, m, self.stat())
