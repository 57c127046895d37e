"""Audio-driven video generation with the port: a reference image and
per-frame whisper embeddings (``cli.get_whisper_emb``'s ``.npy``) -> a
talking video, with the driving wav muxed in when ``--audio_wav`` is
given (the counterpart of the JAX package's ``a2v_inference.py``).

    python -m hivae_tpu_torch.cli.a2v_inference --amd_config config.json \
        --amd_ckpt amd.safetensors --a2m_config a2m.yaml \
        --a2m_ckpt a2m.safetensors --ref_image face.png \
        --audio_emb emb/talk.npy --audio_wav talk.wav --output out/talk.mp4

The AMD model, the A2M head and the SD-VAE serve in bf16 on ``--device``
(CUDA by default). The A2M spec is a json or yaml ``{model_type, model:
{...}}``; its checkpoint a reference-named ``.safetensors`` file or a
checkpoint directory of the port's trainers (an Orbax directory, the JAX
package's format, is refused). The pipeline hands the head audio only, so
of the JAX trainer's ``model_type`` names the audio cross-attention head
and the LearnableToken and SimpleAdaLN heads serve; the heads that
condition on pose (``POSE_HEADS``) are refused with a ``ValueError``
naming the missing input, where the JAX CLI fails in its initialisation.
Without ffmpeg on PATH the muxed file is an AVI; the path written is
printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..data import video as vio
from ..models import a2m as a2m_mod
from ..pipelines import ImageAudio2VideoPipeline
from ..training import checkpoint as ckpt_lib
from ..utils.device import resolve_device
from . import common

# the JAX trainer's model_type names (train_a2m.py), each the head built
A2M_TYPES = {
    "A2MModel_CrossAtten_Audio": lambda cfg, **kw:
        a2m_mod.A2MModelCrossAttnAudio(cfg, "audio", **kw),
    "A2MModel_CrossAtten_Audio_Pose": lambda cfg, **kw:
        a2m_mod.A2MModelCrossAttnAudio(cfg, "audio_pose", **kw),
    "A2MModel_CrossAtten_Pose": lambda cfg, **kw:
        a2m_mod.A2MModelCrossAttnAudio(cfg, "pose", **kw),
    "A2MModel_LearnableToken": lambda cfg, **kw:
        a2m_mod.A2MModelLearnableToken(cfg, **kw),
    "A2MModel_SimpleAdaLN": lambda cfg, **kw:
        a2m_mod.A2MModelLearnableToken(cfg, simple_adaln=True, **kw),
    "A2MModel_CrossAtten_Audio_PosePre": lambda cfg, **kw:
        a2m_mod.A2MModelPosePre(cfg, **kw),
}
# the heads whose conditions read pose latents: the JAX CLIs initialise a
# head with audio inputs only, which fails on these
POSE_HEADS = ("A2MModel_CrossAtten_Audio_Pose", "A2MModel_CrossAtten_Pose",
              "A2MModel_CrossAtten_Audio_PosePre")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--amd_config", type=str, required=True)
    p.add_argument("--amd_ckpt", type=str, required=True)
    p.add_argument("--a2m_config", type=str, required=True,
                   help="json/yaml {model_type, model:{...}}")
    p.add_argument("--a2m_ckpt", type=str, required=True,
                   help="a reference-named .safetensors or a checkpoint "
                        "directory of the port's trainer")
    p.add_argument("--vae_ckpt", type=str, default=None)
    p.add_argument("--model_type", type=str, default="AMD_N")
    p.add_argument("--ref_image", type=str, required=True)
    p.add_argument("--audio_emb", type=str, required=True,
                   help=".npy per-frame whisper embedding (T, M, D)")
    p.add_argument("--audio_wav", type=str, default=None,
                   help="driving .wav to mux into the output video")
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--window", type=int, default=16)
    p.add_argument("--a2m_ref_num_frame", type=int, default=8)
    p.add_argument("--sample_size", type=int, default=256)
    p.add_argument("--video_frames", type=int, default=None,
                   help="the AMD model's window; must equal --window "
                        "(default: --window)")
    p.add_argument("--motion_sample_step", type=int, default=8)
    p.add_argument("--video_sample_step", type=int, default=20)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--quant", type=str, default=None, choices=["int8"],
                   help="int8: the AMD DiT's and the A2M head's ODE loops "
                        "and the VAE decode in w8a8 (ops/quant.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda (the default) never falls back "
                        "to the CPU")
    return p.parse_args(argv)


def load_spec(path: str) -> dict:
    """An A2M spec ``{model_type, model: {...}}`` from json or yaml."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(text)
    return json.loads(text)


def build_a2m(spec: dict, device, dtype: torch.dtype = torch.float32):
    """The A2M head a spec names, on ``device`` in ``dtype``."""
    model_type = spec["model_type"]
    if model_type not in A2M_TYPES:
        raise ValueError(f"A2M model_type {model_type}: one of "
                         f"{sorted(A2M_TYPES)}")
    cfg = a2m_mod.A2MConfig.from_dict(spec.get("model", {}))
    return A2M_TYPES[model_type](cfg, device=device, dtype=dtype)


def refuse_pose_heads(spec: dict, cli: str) -> None:
    """A head that conditions on pose cannot serve or train from audio
    alone: the JAX CLI fails on it in its initialisation (a None pose)."""
    if spec["model_type"] in POSE_HEADS:
        raise ValueError(
            f"{cli}: A2M model_type {spec['model_type']} conditions on pose "
            "latents (pose/ref_pose), and this path passes audio and "
            "ref_audio only; the JAX CLI fails on it the same way")


def load_a2m(args, device, dtype: torch.dtype = torch.bfloat16):
    """The A2M head of ``args.a2m_config`` with the weights of
    ``args.a2m_ckpt`` (``args.use_ema``: a trainer checkpoint's EMA)."""
    spec = load_spec(args.a2m_config)
    refuse_pose_heads(spec, "a2v_inference")
    with common._seeded(device):
        model = build_a2m(spec, device, dtype).eval()
    if args.a2m_ckpt.endswith(".safetensors"):
        report = ckpt_lib.load_pretrain_partial(model, args.a2m_ckpt)
        print(f"converted torch a2m checkpoint; "
              f"missing={len(report['missing'])}")
    else:
        model.load_state_dict(ckpt_lib.load_trained_params(
            args.a2m_ckpt, args.use_ema), strict=True)
    return model


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.video_frames is None:
        args.video_frames = args.window
    elif args.video_frames != args.window:
        raise SystemExit(
            f"--video_frames {args.video_frames} != --window "
            f"{args.window}: the AMD model's temporal geometry must match "
            "the pipeline's window (pass only --window)")
    device = resolve_device(args.device)
    amd = common.load_amd(args, device)
    a2m = load_a2m(args, device)
    vae = common.build_vae(args, device)
    pipe = ImageAudio2VideoPipeline(
        vae, amd, a2m, window=args.window,
        a2m_ref_num_frame=args.a2m_ref_num_frame,
        sample_size=args.sample_size, quant=args.quant)
    audio_emb = np.load(args.audio_emb)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    out = pipe.sample(args.ref_image, audio_emb, output_path=None,
                      motion_sample_step=args.motion_sample_step,
                      video_sample_step=args.video_sample_step,
                      fps=args.fps, generator=common.draws(device, args.seed),
                      max_frames=args.max_frames)
    # written here so that the path printed is the one produced: without
    # ffmpeg the muxed container is an AVI
    written = vio.write_video(args.output, out, fps=args.fps,
                              audio_path=args.audio_wav)
    print(f"generated {out.shape[0]} frames -> {written}"
          f"{' (audio muxed)' if args.audio_wav else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
