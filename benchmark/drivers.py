"""The one general generator of the benchmark's traffic: a traffic file's
``kind`` picks how the port is driven, its other keys are the parameters.

- ``serve``: closed loop, offline batches. ``batch`` clips of ``samples``
  samples, ``buffers`` device-resident input sets (audio and, for a code
  model, template codes) made from the seed, called back to back through
  ``serving.build_serving_fn``'s function; a seeded uniform sample of
  ``keep`` calls' outputs, and the last call's, are kept for the check.
- ``train_cache``: ``clips`` clips staged on the card in the trainer's form,
  ``batch`` rows a step by the trainer's epoch schedule (``EpochBatches``),
  ``steps_per_dispatch`` steps a CUDA graph through
  ``pipelines/graphed.py::ChunkRunner`` plus the epoch's remainder; each
  epoch's losses fetched to the host at its end.
- ``demo``: closed loop, one waiting client. A pool of ``pool`` clips whose
  lengths are fixed (log-spaced from ``min_s`` to ``max_s`` seconds; the
  seed makes the audio and the order), replayed in seeded random orders; a
  request builds the demo batch as ``trainer.demo`` does, runs
  ``demo_step`` and copies the poses to the host; a seeded uniform sample
  of ``keep`` requests, and the longest clip's first, are checked.

Each driver: ``setup()``, ``window(seconds, win)`` returning its end-to-end
values and its work counts, ``free()``, and ``check(control)`` returning the
numbers compared with the reference (``correct.py``).
"""

import math
import time
from typing import Dict, List

import numpy as np
import torch

from . import correct
from .reference import pose as ref_pose
from .weights import (device_generator, generator_weights, port_state_dict, seed_stream,
                      speech_like_audio)


def port_config(conf: dict):
    """The port's configuration tree as ``main.py`` reads the configuration's
    file (its tree and overrides are in the benchmark's configuration file),
    held to the plain numbers the reference reads."""
    from speechdrivestemplates_tpu_torch import config as C

    pc = conf["port_config"]
    cfg = C.Config()
    cfg.DATASET.SPEAKER = C.DEFAULT_SPEAKER
    C.merge_tree(cfg, pc["tree"])
    C.apply_overrides(cfg, list(pc["opts"]))
    C.check_config(cfg)
    m, g = conf["model"], cfg.VOICE2POSE.GENERATOR
    seen = {"norm": g.NORM, "code_dim": g.CLIP_CODE.DIMENSION,
            "leaky_slope": 0.2 if g.LEAKY_RELU else 0.0,
            "num_landmarks": cfg.DATASET.NUM_LANDMARKS, "num_frames": cfg.DATASET.NUM_FRAMES,
            "audio_length": cfg.DATASET.AUDIO_LENGTH, "sample_rate": cfg.DATASET.AUDIO_SR,
            "fps": cfg.DATASET.FPS, "hierarchical_pose": cfg.DATASET.HIERARCHICAL_POSE,
            "speaker": cfg.DATASET.SPEAKER, "lambda_reg": g.LAMBDA_REG,
            "lambda_clip_kl": g.LAMBDA_CLIP_KL, "lr": cfg.TRAIN.LR,
            "code_lr_scaling": g.CLIP_CODE.LR_SCALING, "weight_decay": cfg.TRAIN.WD,
            "precision": cfg.TRAIN.PRECISION}
    bad = {k: (m[k], v) for k, v in seen.items() if m[k] != v}
    if bad:
        raise ValueError(f"the port's configuration departs from the benchmark's: {bad}")
    return cfg


class Reservoir:
    """A uniform sample of at most ``size`` items of a stream, drawn from
    ``rng`` (Algorithm R): every call of a window is as likely to be checked."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.size:
                self.items[j] = item


class Driver:
    def __init__(self, cell: dict, seed: int, device, spans):
        self.conf, self.traffic = cell["config_file"], cell["traffic_file"]
        self.model = self.conf["model"]
        self.seed, self.device, self.spans = seed, torch.device(device), spans
        self.work: Dict[str, float] = {}

    def build_kernels(self) -> None:
        if self.device.type == "cuda":
            from speechdrivestemplates_tpu_torch import kernels

            kernels.build_all(["mel", "conv1", "stem"])

    def stat(self) -> dict:
        return ref_pose.speaker_stat(self.model["speaker"], self.model["hierarchical_pose"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Serve(Driver):
    def setup(self) -> None:
        from speechdrivestemplates_tpu_torch.serving import build_serving_fn

        self.build_kernels()
        t, m, dev = self.traffic, self.model, self.device
        self.cfg = port_config(self.conf)
        self.weights = generator_weights(m, self.seed, dev)
        self.fn, has_code = build_serving_fn(self.cfg, port_state_dict(self.weights), dev)
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
            refs[b] = correct.reference_poses(self.weights, audio, code, m, self.stat())
        if control:
            outs = {b: correct.reference_poses(self.weights, self.bufs[b][0], self.bufs[b][1], m,
                                               self.stat(), quant=correct.fp8) for b in refs}
            pairs = [(outs[b], refs[b]) for b in refs]
        else:
            pairs = [(out, refs[b]) for b, out in self.kept]
        return correct.pose_numbers(pairs, m, self.stat())


class TrainCache(Driver):
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
        self.cfg = port_config(self.conf)
        self.cfg.SYS.SEED = seed_stream(self.seed, "sys") % 2 ** 31
        self.cfg.TRAIN.STEPS_PER_DISPATCH = t["steps_per_dispatch"]
        graphed = dev.type == "cuda"
        self.state = Voice2PoseTrainState(self.cfg, t["clips"], dev, capturable=graphed)
        self.weights = generator_weights(m, self.seed, dev)
        gen = device_generator(self.seed, "cache", dev)
        bank = torch.randn(t["clips"], m["code_dim"], generator=gen, device=dev)
        self.state.load({"generator": port_state_dict(self.weights), "clips_code": bank,
                         "pose_encoder": self.state.pose_encoder.state_dict()})
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
                self.grad1 = correct.adam_first_grads(self.state)
            if at == 3:
                self.change3 = correct.changes(self.state, self.weights, self.bank0)
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
        ref = correct.reference_steps(self.weights, self.bank0, batches, self.model)
        if control:
            prog = correct.reference_steps(self.weights, self.bank0, batches, self.model,
                                           quant=correct.fp8)
        else:
            rows = self.setup_losses[:3]
            prog = {"losses": [dict(zip(self.names, map(float, r))) for r in rows],
                    "grad": self.grad1, "change": self.change3}
        window = torch.cat(self.window_losses) if self.window_losses else torch.zeros(0)
        return correct.train_numbers(prog, ref) + [
            ("nonfinite_losses", float((~torch.isfinite(window)).sum()))]


class Demo(Driver):
    def setup(self) -> None:
        from speechdrivestemplates_tpu_torch.datasets.gesture_dataset import collate
        from speechdrivestemplates_tpu_torch.datasets.speakers_stat import get_speaker_stat
        from speechdrivestemplates_tpu_torch.pipelines.voice2pose import (Voice2PoseTrainState,
                                                                          demo_step)
        from speechdrivestemplates_tpu_torch.utils.audio import crop_pad_audio, parse_audio_length

        self.build_kernels()
        t, m, dev = self.traffic, self.model, self.device
        self.cfg = port_config(self.conf)
        self.cfg.SYS.SEED = seed_stream(self.seed, "sys") % 2 ** 31
        self.state = Voice2PoseTrainState(self.cfg, None, dev)
        self.weights = generator_weights(m, self.seed, dev)
        gen = device_generator(self.seed, "pool", dev)
        self.bank = torch.randn(t["bank_rows"], m["code_dim"], generator=gen, device=dev)
        self.state.load({"generator": port_state_dict(self.weights), "clips_code": self.bank,
                         "pose_encoder": self.state.pose_encoder.state_dict()})
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
            ref = correct.reference_poses(self.weights, audio, c, m, self.stat(), frames)
            out = (correct.reference_poses(self.weights, audio, c, m, self.stat(), frames,
                                           quant=correct.fp8) if control
                   else torch.from_numpy(poses[None]).to(self.device))
            pairs.append((out, ref))
        return correct.pose_numbers(pairs, m, self.stat()) + [("code_not_a_bank_row",
                                                               float(bad_codes))]


DRIVERS = {"serve": Serve, "train_cache": TrainCache, "demo": Demo}


def make(cell: dict, seed: int, device, spans) -> Driver:
    return DRIVERS[cell["traffic_file"]["kind"]](cell, seed, device, spans)
