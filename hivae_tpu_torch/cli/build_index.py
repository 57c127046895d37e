"""Dataset index builder (the counterpart of the JAX package's
``build_index.py``, with its flags): pair each mp4 under ``--video_dir``
with its whisper-embedding file and, optionally, its DWPose video, check
each in a pool of threads, and write the train and eval ``.pkl`` lists
that ``data/datasets.py``'s audio datasets read. It runs on the host; the
lists are the JAX CLI's, entry for entry (the same seeded shuffle).

    python -m hivae_tpu_torch.cli.build_index --video_dir videos \
        --audio_emb_dir emb [--pose_video_dir pose] --output index.pkl \
        [--eval_output eval.pkl --eval_num 10]
"""

from __future__ import annotations

import argparse
import os
import pickle
import random
from concurrent.futures import ThreadPoolExecutor

from ..data import video as vio
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video_dir", type=str, required=True)
    p.add_argument("--audio_emb_dir", type=str, default=None,
                   help="*.npy/*.pt whisper embeddings named like videos")
    p.add_argument("--pose_video_dir", type=str, default=None,
                   help="DWPose mp4s named like videos")
    p.add_argument("--output", type=str, default="index.pkl")
    p.add_argument("--eval_output", type=str, default=None)
    p.add_argument("--eval_num", type=int, default=0,
                   help="hold out N entries for the eval list")
    p.add_argument("--min_frames", type=int, default=17)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def find_sidecar(root: str, name: str, exts):
    """``root/<name><ext>`` or ``root/<name>_emb<ext>`` (older embedding
    files), the first that exists, or None."""
    for stem in (name, name + "_emb"):
        for ext in exts:
            cand = os.path.join(root, stem + ext)
            if os.path.exists(cand):
                return cand
    return None


def check(vp: str, args):
    """(entry, None) for a usable video, else (None, the reason)."""
    name = os.path.splitext(os.path.basename(vp))[0]
    try:
        total, _ = vio.video_metadata(vp)
    except Exception as e:
        return None, f"{vp}: unreadable ({e})"
    if total < args.min_frames:
        return None, f"{vp}: only {total} frames"
    entry = {"video_path": vp}
    if args.audio_emb_dir:
        emb = find_sidecar(args.audio_emb_dir, name, (".npy", ".pt"))
        if emb is None:
            return None, f"{vp}: no audio embedding"
        entry["audio_emb_path"] = emb
    if args.pose_video_dir:
        pose = find_sidecar(args.pose_video_dir, name, (".mp4",))
        if pose is None:
            return None, f"{vp}: no pose video"
        entry["pose_path"] = pose
    return entry, None


def main(argv=None):
    args = parse_args(argv)
    videos = common.mp4s(args.video_dir)
    with ThreadPoolExecutor(max_workers=args.num_workers) as pool:
        results = list(pool.map(lambda vp: check(vp, args), videos))
    entries = [e for e, _ in results if e is not None]
    skipped = [msg for _, msg in results if msg is not None]
    for msg in skipped[:20]:
        print("skip:", msg)
    if len(skipped) > 20:
        print(f"... and {len(skipped) - 20} more skipped")
    random.Random(args.seed).shuffle(entries)
    eval_entries, train_entries = (entries[:args.eval_num],
                                   entries[args.eval_num:])
    with open(args.output, "wb") as f:
        pickle.dump(train_entries, f)
    print(f"wrote {len(train_entries)} train entries -> {args.output}")
    if args.eval_output and eval_entries:
        with open(args.eval_output, "wb") as f:
            pickle.dump(eval_entries, f)
        print(f"wrote {len(eval_entries)} eval entries -> "
              f"{args.eval_output}")
    return train_entries, eval_entries


if __name__ == "__main__":
    main()
