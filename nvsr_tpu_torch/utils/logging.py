"""Metrics/observability: running means, TensorBoard, image/video output.

Reproduces the reference's logging plumbing (reference
train_nerf.py:239-275, nerf_helpers.py:323-379): scalars are running
means over fixed-length deques keyed (metric x eval-group); images go to
TensorBoard as collaged grids with PSNR overlays during training, and to
per-scene PNG dirs / metrics.txt / 30fps mp4 in eval mode.

The port's copy of nvsr_tpu/utils/logging.py: eval-mode PNGs are written
by `utils/png.py`, and mp4s by cv2's VideoWriter, instead of imageio;
the collage and the mp4 writer keep their lazy cv2 imports (only the
training writer and `--eval video` reach them).
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np

from nvsr_tpu_torch.utils import png


class RunningScores:
    """Deque-backed running means (reference train_nerf.py:239-240,
    245-255)."""

    def __init__(self, metrics, groups, maxlens):
        """maxlens: {group: deque length}."""
        self._maxlens = dict(maxlens)
        self.scores = {
            m: {g: deque(maxlen=maxlens[g]) for g in groups}
            for m in metrics}

    def add(self, metric: str, group: str, value: float):
        # a metric outside the constructor's list (one that only some
        # runs or iterations write) registers here, lazily: a KeyError
        # here would kill an eval mid-run
        if metric not in self.scores:
            self.scores[metric] = {
                g: deque(maxlen=ml) for g, ml in self._maxlens.items()}
        if group not in self.scores[metric]:
            self.scores[metric][group] = deque(
                maxlen=self._maxlens.get(group, 100))
        self.scores[metric][group].append(value)

    def mean(self, metric: str, group: str) -> float:
        d = self.scores[metric][group]
        return float(np.nanmean(d)) if len(d) else float("nan")

    def full(self, metric: str, group: str) -> bool:
        d = self.scores[metric][group]
        return len(d) == d.maxlen

    def state_dict(self):
        return {m: {g: list(d) for g, d in groups.items()}
                for m, groups in self.scores.items()}

    def load_state_dict(self, state):
        for m, groups in state.items():
            for g, values in groups.items():
                if m in self.scores and g in self.scores[m]:
                    self.scores[m][g].extend(values)


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(img), 0, 1)).astype(np.uint8)


def write_mp4(path: str, frames_u8, fps: int = 30) -> bool:
    """30fps mp4 (reference train_nerf.py:271-273) through cv2's
    VideoWriter; keeps PNGs on failure."""
    try:
        import cv2
        h, w = frames_u8[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if not writer.isOpened():
            raise IOError("VideoWriter failed to open")
        for frame in frames_u8:
            writer.write(frame[..., ::-1])  # RGB -> BGR
        writer.release()
        return True
    except Exception as e:
        print(f"mp4 write failed ({e}); keeping PNGs only")
        return False


def annotate(img_u8: np.ndarray, text: str = None,
             psnr: float = None) -> np.ndarray:
    """PSNR/text overlay (reference cast_to_image,
    nerf_helpers.py:346-379); best-effort via cv2."""
    import cv2
    img = np.ascontiguousarray(img_u8)
    scale = max(0.5, img.shape[1] / 200.0)
    if text:
        cv2.putText(img, text, (0, int(15 * scale)), cv2.FONT_HERSHEY_PLAIN,
                    scale, (255, 255, 255), max(1, int(np.sqrt(scale))))
    if psnr is not None:
        cv2.putText(img, "%.2f" % psnr,
                    (max(0, img.shape[1] // 2 - int(15 * scale)),
                     img.shape[0] - 2),
                    cv2.FONT_HERSHEY_PLAIN, scale, (255, 255, 255),
                    max(1, int(np.sqrt(scale))))
    return img


def arrange_images(images, text: str = None, psnrs=()) -> np.ndarray:
    """Collage a list of [H,W,3] float images into one grid [3,H',W']
    (reference arange_ims, nerf_helpers.py:323-344)."""
    import cv2
    psnrs = list(psnrs) + [None] * (len(images) - len(psnrs))
    sizes = sorted([im.shape[:2] for im in images],
                   key=lambda s: s[0] * s[1])
    target = sizes[-1]
    num_cols = 1
    while (num_cols * target[1]
           < -(-len(images) // num_cols) * target[0]):
        if num_cols == len(images):
            break
        num_cols += 1
    cells = []
    for i, im in enumerate(images):
        u8 = to_uint8(im)
        if u8.shape[:2] != tuple(target):
            u8 = cv2.resize(u8, dsize=(target[1], target[0]),
                            interpolation=cv2.INTER_NEAREST)
        cells.append(annotate(u8, text if i == 0 else None, psnrs[i]))
    rows = []
    for r in range(0, len(cells), num_cols):
        row = np.concatenate(cells[r:r + num_cols], axis=1)
        pad = num_cols * target[1] - row.shape[1]
        if pad:
            row = np.pad(row, ((0, 0), (0, pad), (0, 0)))
        rows.append(row)
    return np.concatenate(rows, axis=0).transpose(2, 0, 1)


class ExperimentLogger:
    """Dispatches scalars/images to TensorBoard (training) or to
    per-scene result folders (eval), matching reference
    write_scalar/write_image (train_nerf.py:245-275). With writes=False
    (every rank of a data-parallel run but rank 0) nothing is written;
    the running means are kept all the same, so every rank holds rank
    0's."""

    def __init__(self, logdir: str = None, results_dir: str = None,
                 eval_mode: str = None, running: RunningScores = None,
                 skip_metrics: bool = False, writes: bool = True):
        self.eval_mode = eval_mode
        self.results_dir = results_dir
        self.running = running
        self.skip_metrics = skip_metrics
        self.writes = writes
        self.writer = None
        if logdir is not None and not eval_mode and writes:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(logdir)
            except Exception:
                self.writer = None
        self._eval_seq_names: list = []

    def set_eval_sequences(self, names):
        self._eval_seq_names = list(names)

    def write_scalar(self, name: str, value, index):
        if self.eval_mode:
            if self.skip_metrics or not self.writes:
                return
            folder = os.path.join(self.results_dir,
                                  self._eval_seq_names[index])
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "metrics.txt"), "a") as f:
                v = float(np.nanmean(value)) if isinstance(value, list) \
                    else float(value)
                f.write("%s: %f\n" % (name, v))
        else:
            group, metric = name.split("/")
            if self.running is not None:
                self.running.add(metric, group, float(value))
                value = self.running.mean(metric, group)
            if self.writer is not None:
                self.writer.add_scalar(name, value, index)

    def write_images(self, name: str, images, text: str, iteration,
                     psnrs=(), psnr_gains=(), white_bg: bool = False):
        if not self.writes:
            return
        if self.eval_mode:
            scene_name = self._eval_seq_names[int(text)]
            folder = os.path.join(self.results_dir,
                                  ("WB_" if white_bg else "") + scene_name)
            os.makedirs(folder, exist_ok=True)
            eval_name = ("blind_" if "blind" in name else "") \
                + name.split("_")[-1]
            gains = list(psnr_gains) or list(psnrs)
            subdir = os.path.join(folder, eval_name)
            os.makedirs(subdir, exist_ok=True)
            for i, im in enumerate(images):
                suffix = ""
                if i < len(gains) and gains[i] is not None:
                    suffix = ("_PSNR%.2f" % gains[i]).replace(".", "_")
                png.imwrite(os.path.join(subdir, f"{i}{suffix}.png"),
                            to_uint8(im))
            if self.eval_mode == "video":
                vid = os.path.join(
                    folder, "%s_%s_%s.mp4" % (
                        eval_name, scene_name,
                        os.path.basename(self.results_dir)))
                write_mp4(vid, [to_uint8(im) for im in images], fps=30)
        elif self.writer is not None:
            self.writer.add_image(name, arrange_images(images, text, psnrs),
                                  iteration)
