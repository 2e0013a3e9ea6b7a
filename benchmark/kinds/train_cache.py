"""Traffic kind ``train_cache``: ``clips`` clips staged on the card in the
trainer's form, ``batch`` rows a step by the trainer's epoch schedule
(``EpochBatches``), ``steps_per_dispatch`` steps a CUDA graph through
``pipelines/graphed.py::ChunkRunner`` plus the epoch's remainder; each epoch's
losses fetched to the host at its end."""

import time
from typing import List

import numpy as np
import torch

from .. import correct, drivers
from ..drivers import port_config
from ..weights import device_generator, seed_stream, seeded_weights, speech_like_audio


class Driver(drivers.Driver):
    """Set-up drives the train state through its first steps on the window's
    own call and feed, on distinct rows of the first epoch's schedule: step 1
    eager (the runner's warm chunk), steps 2-3 a captured chunk of 2, then a
    captured chunk of K (and of the epoch's remainder where that is another
    length), so every length the window replays is captured before it. The
    first gradient is read from Adam's state after step 1, the weights'
    change after step 3."""

    def setup(self) -> None:
        from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import EpochBatches
        from speechdrivestemplates_tpu_torch.pipelines.graphed import ChunkRunner, index_tensor
        from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                          train_step)

        self.build_kernels()
        t, m, dev = self.traffic, self.model, self.device
        self.cfg = port_config(self.conf, self.mm)
        self.cfg.SYS.SEED = seed_stream(self.seed, "sys") % 2 ** 31
        self.cfg.TRAIN.STEPS_PER_DISPATCH = t["steps_per_dispatch"]
        graphed = dev.type == "cuda"
        self.state = Voice2PoseTrainState(self.cfg, t["clips"], dev, capturable=graphed)
        self.weights = seeded_weights(self.mm, m, self.seed, dev)
        gen = device_generator(self.seed, "cache", dev)
        bank = torch.randn(t["clips"], m["code_dim"], generator=gen, device=dev)
        self.state.load(self.mm.port_parts(self.state, self.weights, bank))
        self.bank0 = bank
        samples = int(m["num_frames"] * m["sample_rate"] / m["fps"])
        n, st = t["clips"], self.stat()
        self.cache = {
            "audio": speech_like_audio(n, samples, gen, dev),
            "poses": torch.randn(n, m["num_frames"], 2, m["num_landmarks"], generator=gen,
                                 device=dev),
            "clip_index": torch.arange(n, device=dev),
            "speaker_stat": {k: torch.as_tensor(v).to(dev).expand(n, *np.shape(v)).contiguous()
                             for k, v in st.items()}}
        self.work = {"batch": t["batch"], "samples": samples}
        self.runner = ChunkRunner(self.state, train_step, self.cache, graphed=graphed)
        self.batches = EpochBatches(n, t["batch"], self.cfg.SYS.SEED)
        self.index_tensor = index_tensor
        self.batches.set_epoch(0)
        first = np.stack(self.batches.index_batches())
        K = t["steps_per_dispatch"]
        rem = (n // t["batch"]) % K
        plan = [1, 2, K] + ([rem] if rem not in (0, 2, K) else [])
        self.setup_rows = first[:sum(plan)]
        idx = index_tensor(first[:sum(plan)], dev)
        rows, at = [], 0
        for length in plan:
            rows.append(self.runner.run(idx[at:at + length]))
            at += length
            if at == 1:
                self.grad1 = self.mm.first_grads(self.state)
            if at == 3:
                self.change3 = self.mm.changes(self.state, self.weights, self.bank0)
        self.setup_losses = torch.cat(rows).cpu()
        self.names = list(self.runner.names)
        self.sync()

    def window(self, seconds: float, win) -> dict:
        t, state = self.traffic, self.state
        K, steps, epoch = t["steps_per_dispatch"], 0, 0
        self.window_losses = []
        win.start()
        end = win.t0 + int(seconds * 1e9)
        done = False
        while not done:
            epoch += 1
            self.batches.set_epoch(epoch)
            with self.spans.span("index_copy", epoch):
                schedule = self.index_tensor(np.stack(self.batches.index_batches()), self.device)
            rows = []
            for c0 in range(0, len(schedule), K):
                with self.spans.span("run", steps):
                    rows.append(self.runner.run(schedule[c0:c0 + K]))
                steps += len(rows[-1])
                if time.perf_counter_ns() >= end:
                    done = True
                    break
            with self.spans.span("loss_fetch", epoch):
                self.window_losses.append(torch.cat(rows).cpu())
            if not done:
                state.end_epoch()
        with self.spans.span("sync"):
            win.stop()
        self.work.update(calls=steps, clips=steps * t["batch"])
        return {"train_clips_per_s": steps * t["batch"] / win.seconds, "attempted": steps}

    def free(self) -> None:
        self.runner = self.state = None

    def check(self, control: bool = False) -> List[tuple]:
        batches = []
        for rows in self.setup_rows[:3]:
            idx = torch.as_tensor(rows, device=self.device)
            batches.append({k: self.cache[k][idx] for k in ("audio", "poses", "clip_index")})
        ref = self.mm.reference_steps(self.weights, self.bank0, batches, self.model)
        if control:
            prog = self.mm.reference_steps(self.weights, self.bank0, batches, self.model,
                                           quant=correct.fp8)
        else:
            rows = self.setup_losses[:3]
            prog = {"losses": [dict(zip(self.names, map(float, r))) for r in rows],
                    "grad": self.grad1, "change": self.change3}
        window = torch.cat(self.window_losses) if self.window_losses else torch.zeros(0)
        return correct.train_numbers(prog, ref) + [
            ("nonfinite_losses", float((~torch.isfinite(window)).sum()))]
