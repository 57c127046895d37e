"""Text conditioning for the T2M head (the port's own copy of
``hivae_tpu/data/text.py``).

Text enters the head as an embedding: by a CLIP text model on ``device``
(the card by default) when ``model_path`` names a checkpoint, which
``transformers`` must load (a path that does not load raises: no silent
stand-in for real weights); without ``model_path`` by a deterministic
fallback on the host with the same shape contract (each whitespace token's
sha256 seeds a unit-normal draw; rows padded with zeros to
``max_length``), which gives the JAX package's bits.
``Label2MotionDiffusionDecoder`` takes the pooled (N, width) embedding as
a float ``label``.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np


class TextEncoder:
    """Frozen CLIP text encoder with a deterministic fallback.

    ``__call__(texts)`` -> (sequence (N, max_length, width), pooled (N,
    width)), fp32 numpy; the fallback's pooled row is the sequence's mean.
    With ``model_path`` the CLIP model and its token ids sit on ``device``
    (``utils.device.resolve_device``: CUDA unless the caller asks for
    another device); a checkpoint that does not load raises.
    """

    def __init__(self, model_path: Optional[str] = None, width: int = 512,
                 max_length: int = 77, device=None):
        self.width = width
        self.max_length = max_length
        self._model = None
        self._tokenizer = None
        self.device = None
        if model_path:
            from ..utils.device import resolve_device

            self.device = resolve_device(device)
            try:
                from transformers import CLIPTextModel, CLIPTokenizer

                self._tokenizer = CLIPTokenizer.from_pretrained(model_path)
                self._model = CLIPTextModel.from_pretrained(model_path)
            except Exception as e:
                raise RuntimeError(f"TextEncoder: cannot load a CLIP text "
                                   f"model from {model_path!r}: {e}") from e
            self._model = self._model.to(self.device).eval()
            self.width = self._model.config.hidden_size

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        if self._model is not None:
            import torch

            batch = self._tokenizer(
                texts, truncation=True, max_length=self.max_length,
                padding="max_length", return_tensors="pt")
            with torch.no_grad():
                out = self._model(
                    input_ids=batch["input_ids"].to(self.device))
            return (out.last_hidden_state.float().cpu().numpy(),
                    out.pooler_output.float().cpu().numpy())
        seq = np.stack([self._fallback_sequence(t) for t in texts])
        return seq, seq.mean(axis=1)

    def _fallback_sequence(self, text: str) -> np.ndarray:
        """(max_length, width): one seeded unit-normal row a token, zero
        rows after the text."""
        rows = []
        for tok in text.lower().split()[: self.max_length]:
            seed = int.from_bytes(
                hashlib.sha256(tok.encode()).digest()[:4], "little")
            rows.append(np.random.RandomState(seed).randn(
                self.width).astype(np.float32))
        while len(rows) < self.max_length:
            rows.append(np.zeros(self.width, np.float32))
        return np.stack(rows)


def load_text_embedding(path: str) -> np.ndarray:
    """A precomputed pooled embedding (.npy), fp32."""
    return np.load(path).astype(np.float32)
