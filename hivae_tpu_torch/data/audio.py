"""Host-side audio features for the A2M head (the port's own copy of
``hivae_tpu/data/audio.py``).

``AudioProcessor`` runs a Wav2Vec2 encoder from a local checkpoint
directory (``model_path``), its hidden states linearly interpolated to the
video's frame count and concatenated on the feature axis; without one it
gives a deterministic filterbank feature of the same width, so the audio
paths run where no weights are at hand. ``transformers`` is imported only
when the weights are there. ``load_whisper_embedding`` reads the per-frame
(T, M, D) whisper embeddings the A2M head consumes; ``read_wav`` a mono
float waveform at 16 kHz.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def linear_interpolation(features: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, T, C) -> (B, seq_len, C), linear on the time axis with the ends
    aligned."""
    features = features.transpose(1, 2)
    out = F.interpolate(features, size=seq_len, align_corners=True,
                        mode="linear")
    return out.transpose(1, 2)


class AudioProcessor:
    """Wav2Vec2 features per video frame; ``model_path`` a local Wav2Vec2
    checkpoint directory, or None (or missing) for the filterbank
    fallback, which keeps the width contract: ``features_per_frame``
    times ``num_hidden_states`` (the 13 hidden states of wav2vec2-base), or
    ``features_per_frame`` with ``only_last_features``."""

    def __init__(self, model_path: Optional[str] = None,
                 sampling_rate: int = 16000, features_per_frame: int = 768,
                 only_last_features: bool = False,
                 num_hidden_states: int = 13):
        self.sampling_rate = sampling_rate
        self.only_last_features = only_last_features
        self.features_per_frame = features_per_frame
        self.num_hidden_states = num_hidden_states
        self.model = None
        if model_path and os.path.exists(model_path):
            from transformers import Wav2Vec2Model

            self.model = Wav2Vec2Model.from_pretrained(model_path)
            self.model.eval()

    @torch.no_grad()
    def __call__(self, waveform: np.ndarray, video_frames: int) -> np.ndarray:
        """waveform (T,) float mono at 16 kHz -> (video_frames, D)."""
        wav = torch.from_numpy(np.asarray(waveform, np.float32))[None]
        if self.model is not None:
            out = self.model(wav, output_hidden_states=True)
            if self.only_last_features:
                states = [out.last_hidden_state]
            else:
                states = list(out.hidden_states)
            feats = [linear_interpolation(h, video_frames) for h in states]
            return torch.cat(feats, dim=-1)[0].numpy()
        return self._filterbank(wav, video_frames)

    def _filterbank(self, wav: torch.Tensor, video_frames: int) -> np.ndarray:
        """The fallback: the log-magnitude STFT (512-point Hann window, hop
        256, centred) interpolated to the frames and tiled to the width."""
        n_fft = 512
        spec = torch.stft(wav[0], n_fft=n_fft, hop_length=n_fft // 2,
                          return_complex=True, center=True,
                          window=torch.hann_window(n_fft))
        logmag = torch.log1p(spec.abs()).T[None]  # (1, T, F)
        feats = linear_interpolation(logmag, video_frames)[0]
        d = self.features_per_frame * (1 if self.only_last_features
                                       else self.num_hidden_states)
        reps = -(-d // feats.shape[-1])
        return feats.repeat(1, reps)[:, :d].numpy()


def load_whisper_embedding(path: str) -> np.ndarray:
    """A precomputed whisper embedding file (.npy, or a torch .pt of a
    tensor or an array) -> (T, M, D) float32."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    emb = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(emb, torch.Tensor):
        return emb.float().numpy()
    return np.asarray(emb, np.float32)


def read_wav(path: str, target_rate: int = 16000) -> np.ndarray:
    """Mono float32 waveform at ``target_rate``: PCM scaled by its source
    dtype (int16, int32, unsigned 8-bit; float as is), channels averaged,
    then resampled linearly."""
    from scipy.io import wavfile

    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = np.asarray(data, np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if rate != target_rate:
        n_out = int(len(data) * target_rate / rate)
        x_old = np.linspace(0, 1, len(data))
        x_new = np.linspace(0, 1, n_out)
        data = np.interp(x_new, x_old, data).astype(np.float32)
    return data
