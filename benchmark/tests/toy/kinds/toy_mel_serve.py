"""A toy traffic kind: a closed loop over ``buffers`` seeded batches of
``batch`` clips of ``samples`` samples; a call is the port's mel and the toy
head, and every call's poses are checked."""

import time
from typing import List

import torch

from .. import correct, drivers
from ..reference import pose as ref_pose
from ..reference import toy_mel_head as ref_toy
from ..weights import device_generator, seeded_weights, speech_like_audio


class Driver(drivers.Driver):
    def setup(self) -> None:
        from speechdrivestemplates_tpu_torch.ops.mel import mel_spectrogram

        self.build_kernels()
        t, m, dev = self.traffic, self.model, self.device
        self.weights = seeded_weights(self.mm, m, self.seed, dev)
        gen = device_generator(self.seed, "inputs", dev)
        self.bufs = [speech_like_audio(t["batch"], t["samples"], gen, dev)
                     for _ in range(t["buffers"])]

        def call(audio):
            with torch.no_grad():
                pred = ref_toy.forward(self.weights, mel_spectrogram(audio), m["num_frames"],
                                       m["num_landmarks"])
                return ref_pose.final_poses(pred, self.stat(), m["hierarchical_pose"])

        self.call = call
        for audio in self.bufs:
            call(audio)
        self.sync()

    def window(self, seconds: float, win) -> dict:
        t, n, i = self.traffic, len(self.bufs), 0
        self.kept = []
        win.start()
        end = win.t0 + int(seconds * 1e9)
        while True:
            self.kept.append((i % n, self.call(self.bufs[i % n])))
            i += 1
            if time.perf_counter_ns() >= end:
                break
        win.stop()
        self.work = {"calls": i}
        frames = i * t["batch"] * self.model["num_frames"]
        return {"serve_pose_frames_per_s": frames / win.seconds, "attempted": i}

    def free(self) -> None:
        self.call = None

    def check(self, control: bool = False) -> List[tuple]:
        m, st = self.model, self.stat()
        refs = {b: self.mm.reference_poses(self.weights, self.bufs[b], None, m, st)
                for b in {b for b, _ in self.kept}}
        if control:
            pairs = [(self.mm.reference_poses(self.weights, self.bufs[b], None, m, st,
                                              quant=correct.fp8), refs[b]) for b in refs]
        else:
            pairs = [(out, refs[b]) for b, out in self.kept]
        return correct.pose_numbers(pairs, m, st)
