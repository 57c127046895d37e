"""Offline text embeddings for the T2M head with the port (the counterpart
of the JAX package's ``get_clip_emb.py``: the same flags and files).

    python -m hivae_tpu_torch.cli.get_clip_emb --captions caps.txt \
        --output_dir embs/ [--clip_path CLIP_DIR [--device cuda]] \
        [--save_sequence]

Reads captions (one a line, or "name<TAB>caption"; blank lines skipped,
an unnamed caption is ``caption_<line index>``) and writes one pooled
embedding ``<name>.npy`` a caption (and ``<name>_seq.npy``, the (77, D)
token sequence, with ``--save_sequence``) into ``--output_dir``.
``--clip_path`` loads a CLIP text model through ``transformers`` and runs
it on ``--device`` (the card by default); a path that does not load is an
error. Without it the deterministic fallback of ``data.text.TextEncoder``
writes the JAX CLI's bits, on the host.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from ..data.text import TextEncoder


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--captions", type=str, required=True,
                   help="text file: 'caption' or 'name\\tcaption' per line")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--clip_path", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the CLIP model (with --clip_path)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--save_sequence", action="store_true",
                   help="also save the (77, D) token sequence")
    return p.parse_args(argv)


def read_captions(path: str):
    """(names, texts) of a captions file."""
    names, texts = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if "\t" in line:
                name, text = line.split("\t", 1)
            else:
                name, text = f"caption_{i:05d}", line
            names.append(name)
            texts.append(text)
    return names, texts


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    enc = TextEncoder(args.clip_path, width=args.width, device=args.device)
    names, texts = read_captions(args.captions)
    seq, pooled = enc(texts)
    for name, s, z in zip(names, seq, pooled):
        np.save(os.path.join(args.output_dir, f"{name}.npy"), z)
        if args.save_sequence:
            np.save(os.path.join(args.output_dir, f"{name}_seq.npy"), s)
    print(f"wrote {len(names)} embeddings (dim {pooled.shape[-1]}) "
          f"to {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
