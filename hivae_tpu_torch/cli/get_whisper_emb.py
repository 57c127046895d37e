"""Per-frame whisper embeddings for the A2M head (the counterpart of the
JAX package's ``get_whisper_emb.py``): for every mp4 under
``--video_dir`` with a ``.wav`` beside it, one (T, audio_blocks, D) array
for its T frames, saved as ``{stem}.npy`` in ``--output_dir``.

    python -m hivae_tpu_torch.cli.get_whisper_emb --video_dir videos \
        --output_dir emb [--whisper_path whisper-tiny]

With a local whisper checkpoint directory (``--whisper_path``) the
encoder of ``transformers``' ``WhisperModel`` runs on ``--device`` and
each frame takes the ``audio_blocks`` encoder rows from its time on (50
rows a second). Without one, ``data.audio.AudioProcessor``'s filterbank
features (384 wide, whisper-tiny's width) of each frame are repeated
``audio_blocks`` times, on the host. A video that fails is reported and
skipped.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data import video as vio
from ..data.audio import AudioProcessor, read_wav
from ..utils.device import resolve_device
from . import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--video_dir", type=str, required=True,
                   help="tree containing .mp4 files with .wav siblings")
    p.add_argument("--output_dir", type=str, default="whisper_emb")
    p.add_argument("--whisper_path", type=str, default=None,
                   help="local whisper-tiny checkpoint dir")
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--audio_blocks", type=int, default=50)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the whisper encoder runs (with "
                        "--whisper_path); the fallback features are "
                        "computed on the host")
    return p.parse_args(argv)


@torch.no_grad()
def extract_whisper(model, waveform, sr, num_frames, blocks, fps,
                    device=None) -> np.ndarray:
    """(num_frames, blocks, D) whisper encoder rows: the encoder covers a
    30 s window at a fixed 50 rows a second, and frame f takes the
    ``blocks`` rows from f / fps seconds on (zeros past the end)."""
    from transformers import WhisperFeatureExtractor

    fe = WhisperFeatureExtractor()
    feats = fe(waveform, sampling_rate=sr, return_tensors="pt")
    enc = model.encoder(feats.input_features.to(device)).last_hidden_state
    enc = enc[0].float().cpu()
    rows_per_sec = enc.shape[0] / 30.0
    out = np.zeros((num_frames, blocks, enc.shape[-1]), np.float32)
    for f in range(num_frames):
        start = int(f / fps * rows_per_sec)
        chunk = enc[start:start + blocks].numpy()
        out[f, :chunk.shape[0]] = chunk
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    model = device = None
    if args.whisper_path and os.path.exists(args.whisper_path):
        from transformers import WhisperModel

        device = resolve_device(args.device)
        model = WhisperModel.from_pretrained(args.whisper_path).to(device)
        model.eval()
    # whisper-tiny's per-frame width, one feature set
    fallback = AudioProcessor(features_per_frame=384,
                              only_last_features=True)
    os.makedirs(args.output_dir, exist_ok=True)
    failed = 0
    for vp in common.mp4s(args.video_dir):
        wav_path = os.path.splitext(vp)[0] + ".wav"
        if not os.path.exists(wav_path):
            print(f"skip (no wav): {vp}")
            continue
        try:
            total, fps = vio.video_metadata(vp)
            wav = read_wav(wav_path)
            if model is not None:
                emb = extract_whisper(model, wav, 16000, total,
                                      args.audio_blocks, fps, device)
            else:
                flat = fallback(wav, total)  # (T, D)
                emb = np.repeat(flat[:, None], args.audio_blocks, axis=1)
            name = os.path.splitext(os.path.basename(vp))[0]
            np.save(os.path.join(args.output_dir, f"{name}.npy"), emb)
            print(f"{vp}: {emb.shape}")
        except Exception as e:  # report, and go on with the next video
            failed += 1
            print(f"FAILED {vp}: {e}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
