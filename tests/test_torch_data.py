"""The port's training data path (``hivae_tpu_torch/data/flow_mask.py`` and
``data/datasets.py``) against the JAX package's on the CPU: the optical-flow
camera mask, the four index kinds, the clip and pair datasets (grey twins
and camera masks included), the retry on a broken file and the threaded
loader's order, shard padding and error propagation.

Both sides decode the same synthetic mp4s (a textured pan with a moving
square, written here with OpenCV) from the same seeds, so every comparison
is exact."""

import csv
import os
import pickle
import random

import numpy as np
import pytest

from hivae_tpu.data import datasets as jds
from hivae_tpu.data import flow_mask as jflow
from hivae_tpu_torch.data import datasets as tds
from hivae_tpu_torch.data import flow_mask as tflow

FRAMES = 24
PIX = 64


def _frames(seed, frames=FRAMES, size=PIX, pan=2, speed=3):
    """A textured background panning ``pan`` px a frame and a bright
    square moving ``speed`` px a frame the other way: RGB uint8."""
    rng = np.random.RandomState(seed)
    tex = (rng.rand(size, size * 3, 3) * 255).astype(np.uint8)
    tex = np.repeat(np.repeat(tex[::4, ::4], 4, 0), 4, 1)[:size]
    out = []
    for i in range(frames):
        f = np.ascontiguousarray(tex[:, i * pan:i * pan + size])
        x = (size - 16 - i * speed) % (size - 16)
        f[20:36, x:x + 16] = (255, 40, 40)
        out.append(f)
    return np.stack(out)


def _write_mp4(path, frames, fps=8):
    import cv2

    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f[..., ::-1]))
    vw.release()


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_videos")
    (d / "sub").mkdir()
    for i in range(5):
        _write_mp4(d / ("sub" if i % 2 else ".") / f"clip{i}.mp4",
                   _frames(i, pan=1 + i % 3))
    return d


@pytest.mark.parametrize("pan,speed,ratio", [(2, 3, 0.5), (0, 4, 0.3),
                                             (3, 0, 0.8)])
def test_flow_mask_matches_jax(pan, speed, ratio):
    frames = _frames(7, frames=6, size=96, pan=pan, speed=speed)
    got = tflow.flow_mask(frames[0], frames[-1], mask_video_ratio=ratio,
                          rng=np.random.RandomState(11))
    want = jflow.flow_mask(frames[0], frames[-1], mask_video_ratio=ratio,
                           rng=np.random.RandomState(11))
    for g, w in zip(got, want):
        assert g.shape == (32, 32) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_list_videos_matches_jax_on_every_index_kind(video_dir, tmp_path):
    files = sorted(str(p) for p in video_dir.rglob("*.mp4"))
    pkl = tmp_path / "index.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(files[:2] + [{"video_path": files[2],
                                  "audio_emb_path": "a.npy"}], f)
    txt = tmp_path / "dirs.txt"
    txt.write_text(f"{video_dir / 'sub'}\n\n{video_dir}\n")
    with open(tmp_path / "index.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["videos", "caption"])
        w.writeheader()
        for p in files[:3] + [""]:
            w.writerow({"videos": p, "caption": "x"})
    for src in (str(video_dir), str(pkl), str(txt),
                str(tmp_path / "index.csv")):
        got, want = tds.list_videos(src), jds.list_videos(src)
        assert got == want and got, src
    assert tds.list_videos(str(pkl))[2]["name"] == \
        os.path.splitext(os.path.basename(files[2]))[0]


def _same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, (str, list)):
            assert got[k] == w
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("cls,kw", [
    ("VideoClipDataset", dict(use_grey=True)),
    ("VideoClipDataset", dict(use_grey=True, use_mask=True,
                              mask_latent_size=(16, 8),
                              mask_latent_channels=2)),
    ("VideoClipDataset", dict(use_mask=True, mask_video_ratio=0.3)),
    ("RandomPairDataset", {}),
])
def test_datasets_match_jax(video_dir, cls, kw):
    common = dict(sample_n_frames=4, sample_size=32, seed=3, **kw)
    got_ds = getattr(tds, cls)(str(video_dir), **common)
    want_ds = getattr(jds, cls)(str(video_dir), **common)
    assert len(got_ds) == len(want_ds) == 5
    for idx in (0, 3, 3, 1):
        got, want = got_ds[idx], want_ds[idx]
        _same_sample(got, want)
    # and as batches of the loader, from fresh datasets
    loaders = [mod.DataLoader(getattr(mod, cls)(str(video_dir), **common),
                              batch_size=2, num_workers=1, seed=4)
               for mod in (tds, jds)]
    got_b, want_b = (list(loader) for loader in loaders)
    assert len(got_b) == len(want_b) == 2
    for g, w in zip(got_b, want_b):
        _same_sample(g, w)
    if kw.get("use_mask"):
        h, w = kw.get("mask_latent_size", (32, 32))
        assert got["camera_mask"].shape == (8, kw.get(
            "mask_latent_channels", 4), h, w)
        assert got["camera_mask"].min() == 0.0 and \
            got["camera_mask"].max() == 1.0


def test_broken_file_is_retried_at_a_random_index(video_dir, tmp_path):
    broken = tmp_path / "broken.mp4"
    broken.write_bytes(b"not a video")
    index = [{"name": "broken", "video_path": str(broken)}] + \
        tds.list_videos(str(video_dir))
    got_ds = tds.VideoClipDataset(index, sample_n_frames=4, sample_size=32,
                                  seed=5)
    want_ds = jds.VideoClipDataset(index, sample_n_frames=4, sample_size=32,
                                   seed=5)
    got = got_ds[0]
    assert got["name"] != "broken"
    _same_sample(got, want_ds[0])
    never = tds.VideoClipDataset(index[:1], sample_n_frames=4, seed=5)
    with pytest.raises(RuntimeError, match="decode failures"):
        never[0]


class _Indexed:
    """A dataset whose item i is {"i": i}; item ``bad`` raises."""

    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise IOError(f"item {i}")
        return {"i": np.array(i), "name": f"x{i}"}


@pytest.mark.parametrize("n,batch,shards,drop_last", [
    (10, 3, 1, True), (10, 3, 1, False), (7, 2, 3, True), (2, 1, 4, True)])
def test_loader_order_and_shard_padding_match_jax(n, batch, shards,
                                                  drop_last):
    for shard in range(shards):
        kw = dict(batch_size=batch, num_workers=1, seed=9,
                  drop_last=drop_last, shard_id=shard, num_shards=shards)
        got_loader = tds.DataLoader(_Indexed(n), **kw)
        want_loader = jds.DataLoader(_Indexed(n), **kw)
        assert len(got_loader) == len(want_loader)
        for _ in range(2):   # two epochs: the shuffle is reseeded per epoch
            got = [(b["i"].tolist(), b["name"]) for b in got_loader]
            want = [(b["i"].tolist(), b["name"]) for b in want_loader]
            assert got == want and len(got) == len(got_loader)


def test_loader_raises_a_worker_error_as_jax_does():
    for mod in (tds, jds):
        loader = mod.DataLoader(_Indexed(6, bad=4), batch_size=2,
                                num_workers=1, shuffle=False)
        it = iter(loader)
        assert next(it)["i"].tolist() == [0, 1]
        assert next(it)["i"].tolist() == [2, 3]
        with pytest.raises(RuntimeError, match="worker failed on batch 2") \
                as e:
            next(it)
        assert isinstance(e.value.__cause__, IOError)


def test_loader_with_threads_yields_every_batch_in_order(video_dir):
    ds = tds.VideoClipDataset(str(video_dir), sample_n_frames=4,
                              sample_size=32, use_grey=True, seed=1)
    loader = tds.DataLoader(ds, batch_size=2, num_workers=4, seed=2,
                            drop_last=False)
    names = [b["name"] for b in loader]
    assert [len(x) for x in names] == [2, 2, 1]
    order = list(range(5))
    random.Random(2).shuffle(order)
    assert sum(names, []) == [ds.metadata[i]["name"] for i in order]
