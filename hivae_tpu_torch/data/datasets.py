"""Training datasets and a threaded prefetching loader on the host (the
port's own copy of ``list_videos``, ``VideoClipDataset``,
``RandomPairDataset``, ``VideoAudioDataset``, ``VideoAudioRandomRefDataset``,
``_collate`` and ``DataLoader`` of ``hivae_tpu/data/datasets.py``).

  * ``VideoClipDataset``: fps-resampled consecutive clips; frame 0 is the
    reference frame, repeated over the clip; optional grey twins and the
    optical-flow camera mask; a sample that fails is retried at a random
    index.
  * ``RandomPairDataset``: random non-equal (reference, target) frame
    pairs.
  * ``VideoAudioDataset``, ``VideoAudioRandomRefDataset``: clips with their
    audio embeddings (and a pose stream) for A2M training, the reference
    the frame before the clip or one drawn from outside it.
  * ``LabelVideoDataset``: class-labelled clips for T2M training, the
    label the index of the clip's parent directory name.
  * ``DataLoader``: a pool of threads and a bounded queue feeding stacked
    numpy batches in order. Threads, not worker processes: every sample
    draws from the dataset's one seeded ``random.Random``, and worker
    processes would each draw from a copy of it.

Index sources: a directory searched for mp4s, a ``.pkl`` list, a ``.txt``
of directories, or a ``.csv`` with a ``videos`` column.
"""

from __future__ import annotations

import csv
import glob
import os
import pickle
import queue
import random
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
from torch.utils.data import Dataset

from . import video as vio
from .flow_mask import flow_mask


def list_videos(video_dir: str) -> List[Dict[str, str]]:
    """Index entries {"name", "video_path", ...} of ``video_dir``."""
    if video_dir.endswith(".pkl"):
        with open(video_dir, "rb") as f:
            files = pickle.load(f)
    elif video_dir.endswith(".txt"):
        with open(video_dir) as f:
            dirs = [line.strip() for line in f if line.strip()]
        files = []
        for d in dirs:
            files += glob.glob(os.path.join(d, "**", "*.mp4"), recursive=True)
    elif video_dir.endswith(".csv"):
        with open(video_dir, encoding="ISO-8859-1") as f:
            files = [row["videos"] for row in csv.DictReader(f)
                     if row.get("videos")]
    else:
        files = glob.glob(os.path.join(video_dir, "**", "*.mp4"),
                          recursive=True)
    out = []
    for p in files:
        if isinstance(p, dict):  # pkl entries may carry audio/pose paths
            entry = dict(p)
            entry.setdefault("name", os.path.splitext(
                os.path.basename(entry["video_path"]))[0])
        else:
            entry = {"name": os.path.splitext(os.path.basename(p))[0],
                     "video_path": p}
        out.append(entry)
    return out


class VideoClipDataset(Dataset):
    """Consecutive clips: ``videos`` (T, 3, H, W) in [-1, 1], ``ref_img``
    its reference frame repeated T times, ``name``; with ``use_grey`` the
    grey twins ``grey_videos``/``ref_grey_img``; with ``use_mask`` the
    camera mask of the clip's first and last frame, tiled to
    (2T, mask_latent_channels, *mask_latent_size)."""

    def __init__(self, video_dir, sample_n_frames: int = 16,
                 sample_size: int = 256, target_fps: float = 8,
                 use_grey: bool = False, use_mask: bool = False,
                 mask_video_ratio: float = 0.5, seed: int = 0,
                 mask_latent_size=32, mask_latent_channels: int = 4):
        self.metadata = (list_videos(video_dir) if isinstance(video_dir, str)
                         else list(video_dir))
        self.sample_n_frames = sample_n_frames
        self.sample_size = sample_size
        self.target_fps = target_fps
        self.use_grey = use_grey
        self.use_mask = use_mask
        self.mask_video_ratio = mask_video_ratio
        if isinstance(mask_latent_size, int):
            mask_latent_size = (mask_latent_size, mask_latent_size)
        self.mask_latent_size = tuple(mask_latent_size)
        self.mask_latent_channels = mask_latent_channels
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        # a sample that fails is retried at a random index
        for _ in range(100):
            try:
                return self.get_batch(idx)
            except Exception:
                idx = self.rng.randint(0, len(self) - 1)
        raise RuntimeError("too many consecutive decode failures")

    def get_batch(self, idx: int) -> Dict[str, Any]:
        meta = self.metadata[idx]
        total, fps = vio.video_metadata(meta["video_path"])
        batch_index = vio.sample_frames_with_fps(
            total, fps, self.sample_n_frames + 1, self.target_fps,
            rng=self.rng)
        frames = vio.read_video_frames(meta["video_path"], batch_index)

        pixels = vio.pixel_transform(frames, self.sample_size)  # F+1,C,H,W
        videos = pixels[1:]
        ref_img = np.repeat(pixels[:1], videos.shape[0], axis=0)
        sample = {"name": meta["name"], "videos": videos, "ref_img": ref_img}

        if self.use_grey:
            grey = vio.pixel_transform(vio.to_grayscale(frames),
                                       self.sample_size)
            sample["grey_videos"] = grey[1:]
            sample["ref_grey_img"] = np.repeat(grey[:1], videos.shape[0],
                                               axis=0)
        if self.use_mask:
            # the budget's shuffle draws from the dataset's seeded stream
            mask_rng = np.random.RandomState(self.rng.randrange(2 ** 31))
            cam, _ = flow_mask(frames[0], frames[-1],
                               mask_video_ratio=self.mask_video_ratio,
                               rng=mask_rng)
            cam = cam.astype(np.float32)
            h, w = self.mask_latent_size
            if cam.shape != (h, w):
                import cv2

                cam = cv2.resize(cam, (w, h),
                                 interpolation=cv2.INTER_NEAREST)
            sample["camera_mask"] = np.tile(
                cam[None, None],
                (2 * self.sample_n_frames, self.mask_latent_channels, 1, 1))
        return sample


class RandomPairDataset(VideoClipDataset):
    """Random non-equal (reference, target) frame pairs: ``ref_img`` and
    ``videos`` (T, 3, H, W)."""

    def get_batch(self, idx: int) -> Dict[str, Any]:
        meta = self.metadata[idx]
        total, fps = vio.video_metadata(meta["video_path"])
        n = self.sample_n_frames
        hi = max(total, 2)
        ref_idx = [self.rng.randint(0, hi - 1) for _ in range(n)]
        vid_idx = []
        for r in ref_idx:
            v = self.rng.randint(0, hi - 1)
            while v == r:
                v = self.rng.randint(0, hi - 1)
            vid_idx.append(v)
        frames = vio.read_video_frames(meta["video_path"],
                                       np.array(ref_idx + vid_idx))
        pixels = vio.pixel_transform(frames, self.sample_size)
        return {"name": meta["name"], "ref_img": pixels[:n],
                "videos": pixels[n:]}


class VideoAudioDataset(VideoClipDataset):
    """Clips with their per-frame audio embeddings (whisper ``.npy``, (T,
    M, D)) for A2M training. Index entries {"video_path",
    "audio_emb_path"[, "pose_path"]}: a ``pose_path`` mp4 adds the pose
    stream, read at the same frames. The reference is the frame before
    the clip: ``ref_video`` (its pixels repeated over the clip),
    ``gt_video``, ``ref_audio``, ``gt_audio``, ``mask`` (N,) and, with a
    pose stream, ``ref_pose`` and ``gt_pose``. A clip shorter than the
    window is zero-padded after its frames and masked."""

    def _sample_indices(self, usable: int):
        """-> (index, mask): frame 0 of ``index`` is the reference, the
        rest the clip."""
        n = self.sample_n_frames
        if usable >= n + 1:
            start = self.rng.randint(0, usable - n - 1) if usable > n + 1 \
                else 0
            return np.arange(start, start + n + 1), np.ones((n,), np.float32)
        mask = np.zeros((n,), np.float32)
        mask[:max(usable - 1, 0)] = 1.0
        return np.arange(usable), mask

    def get_batch(self, idx: int) -> Dict[str, Any]:
        meta = self.metadata[idx]
        audio = np.load(meta["audio_emb_path"])
        total, _ = vio.video_metadata(meta["video_path"])
        n = self.sample_n_frames
        index, mask = self._sample_indices(min(total, audio.shape[0]))

        def pad_to(x, length):
            if x.shape[0] >= length:
                return x[:length]
            pad = np.zeros((length - x.shape[0],) + x.shape[1:], x.dtype)
            return np.concatenate([x, pad], axis=0)

        pixels = pad_to(vio.pixel_transform(vio.read_video_frames(
            meta["video_path"], index), self.sample_size), n + 1)
        audio_clip = pad_to(audio[index].astype(np.float32), n + 1)
        sample = {"name": meta["name"],
                  "ref_video": np.repeat(pixels[:1], n, axis=0),
                  "gt_video": pixels[1:], "ref_audio": audio_clip[0],
                  "gt_audio": audio_clip[1:], "mask": mask}
        if meta.get("pose_path"):
            pose = pad_to(vio.pixel_transform(vio.read_video_frames(
                meta["pose_path"], index), self.sample_size), n + 1)
            sample["ref_pose"] = pose[0]
            sample["gt_pose"] = pose[1:]
        return sample


class VideoAudioRandomRefDataset(VideoAudioDataset):
    """``VideoAudioDataset`` with the reference frame (video, pose and
    audio) drawn uniformly from outside the clip, or the clip's first
    frame where no frame lies outside it."""

    def _sample_indices(self, usable: int):
        n = self.sample_n_frames
        if usable >= n:
            start = self.rng.randint(0, usable - n) if usable > n else 0
            clip = np.arange(start, start + n)
            mask = np.ones((n,), np.float32)
        else:
            clip = np.arange(max(usable, 1))
            mask = np.zeros((n,), np.float32)
            mask[:usable] = 1.0
        outside = np.concatenate([np.arange(0, clip[0]),
                                  np.arange(clip[-1] + 1, usable)])
        ref = (int(outside[self.rng.randint(0, len(outside) - 1)])
               if len(outside) else int(clip[0]))
        return np.concatenate([[ref], clip]), mask


class LabelVideoDataset(VideoClipDataset):
    """Class-labelled clips: ``label`` (int32) is the index of the clip's
    parent directory name in ``classes`` (default: the sorted names of
    the index's parent directories; 0 for a name not among them)."""

    def __init__(self, video_dir, classes: Optional[List[str]] = None, **kw):
        super().__init__(video_dir, **kw)
        if classes is None:
            classes = sorted({os.path.basename(os.path.dirname(
                m["video_path"])) for m in self.metadata})
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}

    def get_batch(self, idx: int) -> Dict[str, Any]:
        sample = super().get_batch(idx)
        cls = os.path.basename(os.path.dirname(
            self.metadata[idx]["video_path"]))
        sample["label"] = np.int32(self.class_to_idx.get(cls, 0))
        return sample


def _collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


class DataLoader:
    """Threaded prefetching loader yielding stacked numpy batches in
    order: a seeded shuffle per epoch, ``drop_last``, and for
    ``num_shards`` > 1 wrap-around padding so every shard gets as many
    items (``shard_id`` picks this process's slice). A worker's error is
    raised in the consumer."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0,
                 drop_last: bool = True, shard_id: int = 0,
                 num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.epoch = 0

    def _indices(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.num_shards > 1:
            # wrap-around padding: every shard sees the same number of
            # items, however small the dataset
            total = -(-len(idx) // self.num_shards) * self.num_shards
            reps = -(-total // max(len(idx), 1))
            idx = (idx * reps)[:total]
        return idx[self.shard_id::self.num_shards]

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._indices()
        self.epoch += 1
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        tasks: "queue.Queue" = queue.Queue()
        for item in enumerate(batches):
            tasks.put(item)
        results: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item):
            # a bounded put that rechecks stop, so an abandoned iterator
            # leaves no worker blocked
            while not stop.is_set():
                try:
                    results.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    bi, batch_idx = tasks.get_nowait()
                except queue.Empty:
                    return
                try:
                    samples = [self.dataset[i] for i in batch_idx]
                    _put((bi, _collate(samples)))
                except Exception as e:  # noqa: BLE001 - raised below
                    _put((bi, e))
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            received: Dict[int, Any] = {}
            next_bi = 0
            while next_bi < len(batches):
                while next_bi in received:
                    yield received.pop(next_bi)
                    next_bi += 1
                if next_bi >= len(batches):
                    break
                bi, batch = results.get()
                if isinstance(batch, Exception):
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {bi}"
                    ) from batch
                received[bi] = batch
        finally:
            stop.set()
            # drain, so workers blocked on put() can exit
            while not results.empty():
                results.get_nowait()
            for t in threads:
                t.join(timeout=0.5)
