"""Pose videos into TensorBoard, mp4 files and the demo's filmstrip jpgs.

The port's copy of the JAX package's ``utils/video.py`` (the reference's
``core/utils/video_processing.py``). ``VideoWriter.save_video`` hands one
clip's frames (T, H, W, 3) BGR uint8 to each sink SYS.VIDEO_FORMAT names:
  - ``tensorboard``: RGB, resized to 0.4x with INTER_AREA, as an animated-GIF
    summary ``train/video`` at the global step, or ``{val,test}/video/<step>``
    at the epoch (``utils/tb_native.py``); not for the demo;
  - ``mp4``: ``videos/epoch{E}-{TAG}-step{S}[-{i}].mp4`` and the clip's audio
    beside it as ``.wav`` (scipy); ffmpeg muxes the two where it is on PATH,
    else ``cv2.VideoWriter`` writes the frames alone (fourcc mp4v). A writer
    that does not open is logged as an error naming the path;
  - ``img``: the demo's filmstrip, ``imgs/epoch0-DEMO-step{S}[-{i}].jpg``.
With SYS.ASYNC_VIDEO_SAVING a worker thread runs the sinks from a queue.
Unlike JAX's worker, which is never joined, ``close`` waits for the queue to
drain, so no queued video is lost when a run ends.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import subprocess
import threading
import time

import numpy as np

log = logging.getLogger(__name__)


class VideoWriter:
    """The sinks of one run (see the module docstring)."""

    def __init__(self, cfg) -> None:
        self.q: "queue.Queue" = queue.Queue()
        self.thread = None
        if cfg.SYS.ASYNC_VIDEO_SAVING:
            self.thread = threading.Thread(target=self._worker, name="video-writer", daemon=True)
            self.thread.start()

    def _worker(self) -> None:
        while True:
            job = self.q.get()
            try:
                if job is None:
                    return
                job[0](*job[1])
            except Exception:  # noqa: BLE001 - a failed video must not end the run
                log.exception("async video save failed")
            finally:
                self.q.task_done()

    def _dispatch(self, func, args) -> None:
        if self.thread is not None:
            self.q.put((func, args))
        else:
            func(*args)

    def close(self) -> None:
        """Write every queued video, then stop the worker."""
        if self.thread is not None:
            self.q.put(None)
            self.thread.join()
            self.thread = None

    def save_video(self, cfg, tag, frames, step, epoch, global_step=None, long_img=None,
                   audio=None, writer=None, base_path=None, extra_id=None) -> None:
        """One clip to each sink of SYS.VIDEO_FORMAT; ``tag`` is TRAIN, VAL,
        TEST or DEMO, ``audio`` the clip's samples, ``long_img`` the demo's
        filmstrip, ``writer`` the run's TensorBoard writer."""
        if "tensorboard" in cfg.SYS.VIDEO_FORMAT:
            self._dispatch(self.save_video_in_tensorboard,
                           (cfg, tag, frames, step, epoch, global_step, writer, extra_id))
        if "mp4" in cfg.SYS.VIDEO_FORMAT:
            self._dispatch(self.save_video_in_mp4,
                           (cfg, tag, frames, step, epoch, global_step, audio, base_path,
                            extra_id))
        if "img" in cfg.SYS.VIDEO_FORMAT:
            self._dispatch(self.save_video_in_long_img,
                           (cfg, tag, long_img, step, epoch, global_step, base_path, extra_id))

    @staticmethod
    def save_video_in_long_img(cfg, tag, long_img, step, epoch, global_step, base_path,
                               extra_id=None) -> None:
        if tag != "DEMO" or long_img is None:
            return
        import cv2

        tic = time.time()
        img_dir = os.path.join(base_path, "imgs")
        os.makedirs(img_dir, exist_ok=True)
        suffix = "" if extra_id is None else f"-{extra_id}"
        img_path = f"{img_dir}/epoch{epoch}-{tag}-step{step}{suffix}.jpg"
        if not cv2.imwrite(img_path, long_img):
            log.error("cv2.imwrite could not write %s", img_path)
            return
        log.info("[%s] epoch: %d/%d  step: %d  Saved long image in %.3f seconds.", tag, epoch,
                 cfg.TRAIN.NUM_EPOCHS, step, time.time() - tic)

    @staticmethod
    def save_video_in_tensorboard(cfg, tag, frames, step, epoch, global_step, writer,
                                  extra_id=None) -> None:
        if writer is None or tag == "DEMO":
            return
        import cv2

        tic = time.time()
        if tag == "TRAIN":
            clip_tag, tb_step = "train/video", global_step
        elif tag in ("VAL", "TEST"):
            clip_tag, tb_step = f"{tag.lower()}/video/{step}", epoch
        else:
            raise ValueError(f"Unknown tag: {tag}")
        if extra_id is not None:
            clip_tag += f"/{extra_id}"
        # (T, H, W, 3) BGR uint8 -> (1, T, 3, h, w) RGB float, 0.4x
        fr = frames[..., ::-1].astype(np.float32) / 255.0
        h, w = int(fr.shape[1] * 0.4), int(fr.shape[2] * 0.4)
        fr = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_AREA) for f in fr])
        writer.add_video(clip_tag, np.transpose(fr, (0, 3, 1, 2))[None], tb_step,
                         cfg.DATASET.FPS)
        log.info("[%s] epoch: %d/%d  step: %d  Saved tensorboard videos in %.3f s.", tag, epoch,
                 cfg.TRAIN.NUM_EPOCHS, step, time.time() - tic)

    @staticmethod
    def save_video_in_mp4(cfg, tag, frames, step, epoch, global_step, audio, base_path,
                          extra_id=None) -> None:
        tic = time.time()
        vid_dir = os.path.join(base_path, "videos")
        os.makedirs(vid_dir, exist_ok=True)
        suffix = "" if extra_id is None else f"-{extra_id}"
        stem = f"{vid_dir}/epoch{epoch}-{tag}-step{step}{suffix}"
        vid_path, wav_path = stem + ".mp4", stem + ".wav"
        if audio is not None:
            from scipy.io.wavfile import write as wav_write

            wav_write(wav_path, cfg.DATASET.AUDIO_SR, audio)
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is not None and audio is not None:
            written = _mux_with_ffmpeg(ffmpeg, frames, wav_path, vid_path, cfg.DATASET.FPS)
        else:
            written = _write_with_cv2(frames, vid_path, cfg.DATASET.FPS)
        if written:
            log.info("[%s] epoch: %d/%d  step: %d  Saved mp4 videos in %.3f seconds.", tag,
                     epoch, cfg.TRAIN.NUM_EPOCHS, step, time.time() - tic)


def _write_with_cv2(frames, vid_path: str, fps) -> bool:
    import cv2

    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(vid_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        log.error("cv2.VideoWriter (mp4v, %dx%d) could not open %s: the video is not written",
                  w, h, vid_path)
        return False
    for f in frames:
        vw.write(f.astype(np.uint8))
    vw.release()
    return True


def _mux_with_ffmpeg(ffmpeg: str, frames, wav_path: str, vid_path: str, fps) -> bool:
    """Raw frames piped to ffmpeg and muxed with the wav in one pass."""
    h, w = frames.shape[1:3]
    cmd = [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "bgr24", "-s", f"{w}x{h}",
           "-r", str(fps), "-i", "pipe:0", "-i", wav_path,
           "-c:v", "libx264", "-pix_fmt", "yuv420p", "-c:a", "aac", "-shortest", vid_path]
    proc = subprocess.run(cmd, input=frames.astype(np.uint8).tobytes(),
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    if proc.returncode:
        log.error("ffmpeg exited %d writing %s: %s", proc.returncode, vid_path,
                  proc.stderr.decode(errors="replace")[-500:])
        return False
    return True
