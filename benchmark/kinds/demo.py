"""Traffic kind ``demo``: closed loop, one waiting client. A pool of ``pool``
clips whose lengths are fixed (log-spaced from ``min_s`` to ``max_s``
seconds; the seed makes the audio and the order), replayed in seeded random
orders; a request builds the demo batch as ``trainer.demo`` does, runs
``demo_step`` and copies the poses to the host; a seeded uniform sample of
``keep`` requests, and the longest clip's first, are checked."""

import math
import time
from typing import List

import numpy as np
import torch

from .. import correct, drivers
from ..drivers import Reservoir, port_config
from ..weights import device_generator, seed_stream, seeded_weights, speech_like_audio


class Driver(drivers.Driver):
    def setup(self) -> None:
        from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import collate
        from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat
        from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                          demo_step)
        from speechdrivestemplates_tpu_torch.utils.audio import crop_pad_audio, parse_audio_length

        self.build_kernels()
        t, m, dev = self.traffic, self.model, self.device
        self.cfg = port_config(self.conf, self.mm)
        self.cfg.SYS.SEED = seed_stream(self.seed, "sys") % 2 ** 31
        self.state = Voice2PoseTrainState(self.cfg, None, dev)
        self.weights = seeded_weights(self.mm, m, self.seed, dev)
        gen = device_generator(self.seed, "pool", dev)
        self.bank = torch.randn(t["bank_rows"], m["code_dim"], generator=gen, device=dev)
        self.state.load(self.mm.port_parts(self.state, self.weights, self.bank))
        sr = m["sample_rate"]
        lengths = [int(round(sr * s)) for s in
                   np.exp(np.linspace(math.log(t["min_s"]), math.log(t["max_s"]), t["pool"]))]
        self.pool = [speech_like_audio(1, n, gen, dev)[0].cpu().numpy() for n in lengths]

        def build(k: int) -> dict:
            audio = self.pool[k]
            length, frames = parse_audio_length(len(audio), sr, m["fps"])
            if frames < m["num_frames"]:
                frames = m["num_frames"]
                length = int(frames * sr / m["fps"])
            return collate([{"audio": crop_pad_audio(audio, length).astype(np.float32),
                             "clip_index": np.int32(k),
                             "speaker_stat": get_speaker_stat(m["speaker"], m["num_landmarks"],
                                                              parted=m["hierarchical_pose"]),
                             "num_frames": np.int32(frames)}])

        def request(k: int, r: int):
            with self.spans.span("batch_build", r):
                batch = build(k)
            with self.spans.span("demo_step", r):
                out = demo_step(self.state, batch)
            with self.spans.span("to_host", r):
                poses = out["poses_pred_batch"][0].float().cpu().numpy()
                code = out["condition_code"][0].float().cpu().numpy()
            return poses, code

        self.request = request
        for k in range(len(self.pool)):
            request(k, -1)
        self.sync()

    def window(self, seconds: float, win) -> dict:
        t = self.traffic
        rng = np.random.default_rng(seed_stream(self.seed, "order"))
        sample = Reservoir(t["keep"], np.random.default_rng(seed_stream(self.seed, "keep")))
        longest = int(np.argmax([len(a) for a in self.pool]))
        latencies, first_longest, order, r = [], [], [], 0
        win.start()
        end = win.t0 + int(seconds * 1e9)
        while True:
            if not order:
                order = list(rng.permutation(len(self.pool)))
            k = int(order.pop())
            t0 = time.perf_counter_ns()
            poses, code = self.request(k, r)
            latencies.append((time.perf_counter_ns() - t0) / 1e6)
            sample.offer((k, poses, code))
            if k == longest and not first_longest:
                first_longest.append((k, poses, code))
            r += 1
            if time.perf_counter_ns() >= end:
                break
        win.stop()
        self.kept = sample.items + first_longest
        self.work = {"calls": r, "latencies_ms": latencies}
        return {"demo_p95_ms": float(np.percentile(latencies, 95)), "attempted": r}

    def free(self) -> None:
        self.state = None

    def check(self, control: bool = False) -> List[tuple]:
        m = self.model
        pairs, bad_codes = [], 0
        bank = self.bank.float().cpu().numpy()
        for k, poses, code in self.kept:
            row = np.flatnonzero((bank == code[None]).all(1))
            bad_codes += int(row.size == 0)
            c = torch.from_numpy(bank[row[0] if row.size else 0][None]).to(self.device)
            frames = poses.shape[0]
            length = int(frames * m["sample_rate"] / m["fps"])
            audio = np.zeros(length, np.float32)
            audio[:min(length, len(self.pool[k]))] = self.pool[k][:length]
            audio = torch.from_numpy(audio[None]).to(self.device)
            ref = self.mm.reference_poses(self.weights, audio, c, m, self.stat(), frames)
            out = (self.mm.reference_poses(self.weights, audio, c, m, self.stat(), frames,
                                           quant=correct.fp8) if control
                   else torch.from_numpy(poses[None]).to(self.device))
            pairs.append((out, ref))
        return correct.pose_numbers(pairs, m, self.stat()) + [("code_not_a_bank_row",
                                                               float(bad_codes))]
