"""The port's pose-visualisation CLI (``hivae_tpu_torch.cli.vis``) against
the root ``vis.py`` on the CPU: the same PosePre json spec and
``.safetensors``, the same tiny SD-VAE ``.safetensors``, embeddings (one
with the older ``_emb`` suffix) and pose mp4s, the same numpy seed for the
clip starts. Both compute in fp32; the JAX side's SD-VAE is the tiny one
and its initialisations are shapes filled with zeros (the checkpoints fill
every weight), so nothing but its ``predict`` compiles. The frames each
hands to its writer (the ``f h (b w) c`` grid) are at most one uint8
level apart and equal on 99% of the values. Also: the argument parsers
(the port adds ``--device``) and the refusal of a spec without a pose
predictor."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch

import vis as jvis_cli
from hivae_tpu.models import a2m as ja2m
from hivae_tpu.models import vae as jvae
from hivae_tpu.utils import cache as jcache
from hivae_tpu.utils import misc as jmisc
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import vis
from hivae_tpu_torch.models import a2m as ta2m
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_a2v import C, M, SIZE, VAE_CFG, stack  # noqa: F401
from test_torch_a2v_cli import written  # noqa: F401
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_data import _frames, _write_mp4
from test_torch_serving_pipelines import _same_uint8

LAT = SIZE // 2
FRAMES = 5
# a tiny PosePre head on the tiny SD-VAE's 16x16 latents
POSEPRE = dict(audio_inchannel=C, audio_block=M, motion_num_token=1,
               motion_in_channel=16, motion_frames=4, window_size=2,
               encoder_out_dim=16, intermediate_dim=24, pose_height=LAT,
               pose_width=LAT, pose_inchannel=4, pose_patch_size=2,
               pose_predictor_attn_head_dim=8,
               pose_predictor_attn_num_heads=2,
               pose_predictor_attn_num_layers=2, diffusion_attn_head_dim=8,
               diffusion_attn_num_heads=2, diffusion_num_layers=1)


@pytest.fixture(scope="module")
def files(stack, tmp_path_factory):  # noqa: F811
    """posepre.json, a2m.safetensors, vae.safetensors, emb/ (a.npy,
    b_emb.npy, c.npy) and poses/ (a, b, c mp4s)."""
    _, (vae, _, _) = stack
    d = tmp_path_factory.mktemp("vis_cli")
    spec = {"model_type": "A2MModel_CrossAtten_Audio_PosePre",
            "model": POSEPRE}
    (d / "posepre.json").write_text(json.dumps(spec))
    jmod = ja2m.A2MModelPosePre(cfg=ja2m.A2MConfig(**POSEPRE))
    motion = jnp.zeros((1, 4, 1, 16))
    audio = jnp.zeros((1, 4, M, C))
    pose = jnp.zeros((1, 4, 4, LAT, LAT))
    params = random_params(jmod, motion, motion[:, 0], audio=audio,
                           ref_audio=audio[:, 0], pose=pose,
                           ref_pose=pose[:, 0], seed=9)
    head = ta2m.A2MModelPosePre(ta2m.A2MConfig(**POSEPRE), device="cpu")
    head.load_state_dict(flax_to_torch(params), strict=True)
    safetensors.torch.save_file(
        {k: v.contiguous() for k, v in head.state_dict().items()},
        str(d / "a2m.safetensors"))
    safetensors.torch.save_file(vae.state_dict(), str(d / "vae.safetensors"))
    (d / "emb").mkdir()
    (d / "poses").mkdir()
    rng = np.random.RandomState(1)
    for i, (name, emb_name, frames) in enumerate((
            ("a", "a", 12), ("b", "b_emb", 9), ("c", "c", 10))):
        np.save(d / "emb" / f"{emb_name}.npy",
                rng.randn(frames + 2, M, C).astype(np.float32))
        _write_mp4(d / "poses" / f"{name}.mp4",
                   _frames(i + 20, frames=frames, size=24))
    return d


def _argv(d, out):
    return ["--a2m_config", str(d / "posepre.json"),
            "--a2m_ckpt", str(d / "a2m.safetensors"),
            "--vae_ckpt", str(d / "vae.safetensors"),
            "--audio_emb_dir", str(d / "emb"),
            "--pose_video_dir", str(d / "poses"), "--output_path", str(out),
            "--batch", "2", "--sample_frames", str(FRAMES),
            "--sample_size", str(SIZE), "--fps", "8"]


def test_vis_cli_matches_jax(  # noqa: F811
        files, written, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    monkeypatch.setattr(jmisc, "init_on_cpu", lambda fn: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(fn)))
    vae_cls = jvae.AutoencoderKL
    monkeypatch.setattr(jvae, "AutoencoderKL", lambda dtype: vae_cls(
        cfg=jvae.VAEConfig(**VAE_CFG), dtype=dtype))
    monkeypatch.setattr(cli_common, "VAE_CONFIG", tvae.VAEConfig(**VAE_CFG))
    monkeypatch.setattr(sys, "argv", ["vis.py"] + _argv(
        files, tmp_path / "j.mp4"))
    np.random.seed(7)
    jvis_cli.main()
    np.random.seed(7)
    assert vis.main(_argv(files, tmp_path / "p.mp4") +
                    ["--device", "cpu"]) == 0
    (want, _, _), = written["jax"]
    (got, _, _), = written["port"]
    # (frames, 3, H, 2 W): the two first pairs side by side
    assert got.shape == (FRAMES, 3, SIZE, 2 * SIZE)
    _same_uint8(got, want)
    out = capsys.readouterr().out
    assert f"saved: {tmp_path / 'p.mp4'}" in out
    assert (tmp_path / "p.mp4").stat().st_size > 0


def test_vis_args_match_jax(monkeypatch):
    argv = ["--a2m_config", "a.json", "--audio_emb_dir", "e",
            "--pose_video_dir", "p", "--batch", "3", "--fps", "4"]
    monkeypatch.setattr(sys, "argv", ["vis.py"] + argv)
    want = jvis_cli.parse_args()
    assert vars(vis.parse_args(argv)) == dict(vars(want), device="cuda")


def test_vis_refuses_a_head_without_pose_predictor(files, tmp_path):
    spec = tmp_path / "audio.json"
    spec.write_text(json.dumps({"model_type": "A2MModel_CrossAtten_Audio",
                                "model": POSEPRE}))
    argv = _argv(files, tmp_path / "x.mp4")
    argv[argv.index("--a2m_config") + 1] = str(spec)
    with pytest.raises(ValueError, match="no pose predictor"):
        vis.main(argv + ["--device", "cpu"])
