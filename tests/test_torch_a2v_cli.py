"""The port's audio CLIs against the JAX package's root CLIs, on the CPU:

  * ``cli.a2v_inference`` and ``a2v_inference.py`` on the same tiny AMD_N
    ``config.json`` and reference-named ``.safetensors``, the same tiny
    A2M spec and ``.safetensors``, the same tiny SD-VAE ``.safetensors``,
    reference image, embedding ``.npy`` and wav. Both serve in bf16; the
    comparison runs both packages' models in fp32 (one dtype argument on
    each side), so that the glue is held to the pipelines' own rule: the
    frames each hands to its writer at most one uint8 level apart and
    equal on 99% of the values. The JAX side's VAE is the tiny one and its
    initialisations are shapes filled with zeros (``jax.eval_shape``; the
    checkpoints fill every weight), so no initialisation compiles; its
    draws are recorded as they are made and replayed into the port
    (``test_torch_serving.recorded_draws``). Both mux the wav (an AVI
    here, where ffmpeg is missing) and print the path written;
  * ``cli.get_whisper_emb`` and ``get_whisper_emb.py`` without whisper
    weights on a directory of mp4s with and without a wav beside them:
    equal ``.npy`` files;
  * the argument parsers: the same flags and defaults (the port adds
    ``--device``); every head type of the JAX trainer is built, and the
    CLI serves it or refuses it (the heads that condition on pose, with a
    ``ValueError`` naming it) exactly where the JAX CLI's initialisation
    fails; ``--video_frames`` other than ``--window`` is refused.
"""

import json
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch
from scipy.io import wavfile

import a2v_inference as ja2v
import amd_inference as jinfer
import get_whisper_emb as jwhisper
import test_torch_serving as common
from hivae_tpu.data import video as jvio
from hivae_tpu.models import vae as jvae
from hivae_tpu.utils import cache as jcache
from hivae_tpu.utils import misc as jmisc
from hivae_tpu_torch.cli import a2v_inference, get_whisper_emb
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.data import video as tvio
from hivae_tpu_torch.models import a2m as ta2m
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from test_torch_a2v import A2M_CFG, C, M, SIZE, VAE_CFG, W, stack  # noqa: F401
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_serving_io import _reference_named
from test_torch_serving_pipelines import _same_uint8

FRAMES = 2 * W + 3   # two windows and a ragged tail, plus the reference


@pytest.fixture(scope="module")
def files(stack, tmp_path_factory):
    """config.json, amd.safetensors, a2m.json, a2m.safetensors,
    vae.safetensors, ref.png, emb.npy and talk.wav of the tiny stack."""
    (jvae_mod, _, jamd_mod, _, _, _), (vae, amd, a2m) = stack
    d = tmp_path_factory.mktemp("a2v_cli")
    with open(d / "config.json", "w") as f:
        json.dump(jamd_mod.cfg.to_dict(), f)
    with open(d / "a2m.json", "w") as f:
        json.dump({"model_type": "A2MModel_CrossAtten_Audio",
                   "model": A2M_CFG}, f)
    safetensors.torch.save_file(
        _reference_named(amd.state_dict(), amd.cfg.image_patch_size),
        str(d / "amd.safetensors"))
    safetensors.torch.save_file(
        {k: v.contiguous() for k, v in a2m.state_dict().items()},
        str(d / "a2m.safetensors"))
    safetensors.torch.save_file(vae.state_dict(), str(d / "vae.safetensors"))
    import cv2
    rng = np.random.RandomState(0)
    yy, xx = np.meshgrid(np.linspace(0, 1, 40), np.linspace(0, 1, 48),
                         indexing="ij")
    img = np.stack([np.sin(2 * np.pi * (a * xx + b * yy)) for a, b in
                    rng.uniform(0.5, 2, (3, 2))], -1)
    cv2.imwrite(str(d / "ref.png"), ((img + 1) * 127.5).astype(np.uint8))
    np.save(d / "emb.npy", rng.randn(FRAMES, M, C).astype(np.float32))
    wavfile.write(str(d / "talk.wav"), 16000, (8000 * rng.randn(
        16000)).astype(np.int16))
    return d


def _argv(d, out):
    return ["--amd_config", str(d / "config.json"),
            "--amd_ckpt", str(d / "amd.safetensors"),
            "--a2m_config", str(d / "a2m.json"),
            "--a2m_ckpt", str(d / "a2m.safetensors"),
            "--vae_ckpt", str(d / "vae.safetensors"),
            "--ref_image", str(d / "ref.png"),
            "--audio_emb", str(d / "emb.npy"),
            "--audio_wav", str(d / "talk.wav"), "--output", str(out),
            "--window", str(W), "--a2m_ref_num_frame", "2",
            "--sample_size", str(SIZE), "--motion_sample_step", "2",
            "--video_sample_step", "2", "--fps", "8", "--seed", "3"]


@pytest.fixture
def fp32(monkeypatch):
    """Both CLIs' models in fp32, the JAX side's SD-VAE the tiny one, its
    initialisations zeros of their shapes and its compilation cache off;
    the port's SD-VAE the tiny one."""
    for mod, name in ((jinfer, "load_amd"), (ja2v, "load_a2m")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda args, dtype, _fn=fn: _fn(
            args, jnp.float32))
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    monkeypatch.setattr(jmisc, "init_on_cpu", lambda fn: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(fn)))
    vae_cls = jvae.AutoencoderKL
    monkeypatch.setattr(jvae, "AutoencoderKL", lambda dtype: vae_cls(
        cfg=jvae.VAEConfig(**VAE_CFG), dtype=jnp.float32))
    for name in ("load_amd", "build_vae"):
        monkeypatch.setattr(cli_common, name, partial(
            getattr(cli_common, name), dtype=torch.float32))
    monkeypatch.setattr(a2v_inference, "load_a2m", partial(
        a2v_inference.load_a2m, dtype=torch.float32))
    monkeypatch.setattr(cli_common, "VAE_CONFIG", tvae.VAEConfig(**VAE_CFG))


@pytest.fixture
def written(monkeypatch):
    """(frames, audio path, path returned) of each package's writer call."""
    calls = {"jax": [], "port": []}
    for side, vio in (("jax", jvio), ("port", tvio)):
        def record(path, video, *a, _vio=vio.write_video, _side=side, **k):
            out = _vio(path, video, *a, **k)
            calls[_side].append((np.array(video), k.get("audio_path"), out))
            return out
        monkeypatch.setattr(vio, "write_video", record)
    return calls


def test_a2v_cli_matches_jax(files, fp32, written, monkeypatch, capsys,
                             tmp_path):
    monkeypatch.setattr(sys, "argv", ["a2v_inference.py"] + _argv(
        files, tmp_path / "j.mp4"))
    with common.recorded_draws(monkeypatch) as draws:
        ja2v.main()
    windows = -(-(FRAMES - 1) // W)
    assert len(draws) == 2 * windows
    replay = tamd.SampleDraws(replay=draws)
    monkeypatch.setattr(cli_common, "draws", lambda device, seed: replay)
    assert a2v_inference.main(_argv(files, tmp_path / "p.mp4") +
                              ["--device", "cpu"]) == 0
    assert not replay.replay
    (want, jwav, jout), = written["jax"]
    (got, pwav, pout), = written["port"]
    assert jwav == pwav == str(files / "talk.wav")
    assert jout == str(tmp_path / "j.avi") and pout == str(tmp_path / "p.avi")
    assert got.shape == (FRAMES, 3, SIZE, SIZE)
    _same_uint8(got, want)
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("generated")]
    assert lines == [f"generated {FRAMES} frames -> {jout} (audio muxed)",
                     f"generated {FRAMES} frames -> {pout} (audio muxed)"]


def test_a2v_cli_int8_refused_at_tiny_widths(files, fp32, tmp_path):
    """``--quant int8`` at the tiny widths: no layer of the tiny models
    clears the predicate, and the DiT's and the decoder's tables may not
    be empty (only the A2M head's may): refused loudly, as the JAX
    pipeline refuses."""
    with pytest.raises(ValueError, match="matched no kernels"):
        a2v_inference.main(_argv(files, tmp_path / "q.mp4") + [
            "--device", "cpu", "--quant", "int8"])


def _jax_args(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    return module.parse_args()


@pytest.mark.parametrize("extra", [[], ["--quant", "int8", "--use_ema",
                                        "--max_frames", "9",
                                        "--video_frames", "16"]])
def test_a2v_args_match_jax(monkeypatch, extra):
    argv = ["--amd_config", "c", "--amd_ckpt", "k", "--a2m_config", "a",
            "--a2m_ckpt", "b", "--ref_image", "i", "--audio_emb", "e",
            "--output", "o"] + extra
    want = _jax_args(monkeypatch, ja2v, argv)
    got = a2v_inference.parse_args(argv)
    assert vars(got) == dict(vars(want), device="cuda")


def test_a2v_cli_refusals(files, tmp_path):
    with pytest.raises(SystemExit, match="--video_frames 8 != --window 4"):
        a2v_inference.main(_argv(files, tmp_path / "x.mp4") + [
            "--video_frames", "8", "--device", "cpu"])
    with pytest.raises(ValueError, match="A2M model_type Nope"):
        a2v_inference.build_a2m({"model_type": "Nope"}, "cpu")
    # every JAX trainer head is built, and served or refused exactly where
    # the JAX CLI fails: its load_a2m initialises the head on audio alone
    import inspect
    import re
    import train_a2m
    names = set(re.findall(r'"(A2MModel_\w+)"',
                           inspect.getsource(train_a2m.build_a2m)))
    assert names == set(a2v_inference.A2M_TYPES)
    args = a2v_inference.parse_args(_argv(files, tmp_path / "x.mp4"))
    x = np.zeros((1, W, M, C), np.float32)
    for model_type in sorted(names):
        spec = {"model_type": model_type, "model": dict(
            A2M_CFG, pose_height=4, pose_width=4,
            pose_predictor_attn_head_dim=8, pose_predictor_attn_num_heads=2,
            pose_predictor_attn_num_layers=1)}
        jmod, _ = train_a2m.build_a2m(spec, jnp.float32)
        try:
            jax.eval_shape(lambda: jmod.init(
                {"params": common.KEY, "noise": common.KEY},
                jnp.zeros((1, W, 4, 32)), jnp.zeros((1, 4, 32)),
                audio=jnp.asarray(x), ref_audio=jnp.asarray(x[:, 0])))
            jax_serves = True
        except (TypeError, AttributeError):
            jax_serves = False
        head = a2v_inference.build_a2m(spec, "cpu")
        spec_path = tmp_path / f"{model_type}.json"
        spec_path.write_text(json.dumps(spec))
        args.a2m_config = str(spec_path)
        args.a2m_ckpt = str(tmp_path / "absent.safetensors")
        if jax_serves:
            assert model_type not in a2v_inference.POSE_HEADS
            with torch.no_grad():
                out = ta2m.sample(head, torch.zeros(1, 4, 32), W,
                                  sample_step=1, audio=torch.from_numpy(x),
                                  ref_audio=torch.from_numpy(x[:, 0]),
                                  generator=torch.Generator().manual_seed(0))
            assert out.shape == (1, W, 4, 32)
            with pytest.raises(FileNotFoundError):   # past the refusal
                a2v_inference.load_a2m(args, "cpu", torch.float32)
        else:
            assert model_type in a2v_inference.POSE_HEADS
            with pytest.raises(ValueError, match="conditions on pose"):
                a2v_inference.load_a2m(args, "cpu", torch.float32)
    # an Orbax directory (the JAX package's checkpoints) is refused
    (tmp_path / "orbax" / "checkpoint-1").mkdir(parents=True)
    (tmp_path / "orbax" / "checkpoint-1" / "_METADATA").write_text("{}")
    args = a2v_inference.parse_args(_argv(files, tmp_path / "x.mp4"))
    args.a2m_ckpt = str(tmp_path / "orbax")
    with pytest.raises(ValueError, match="Orbax"):
        a2v_inference.load_a2m(args, "cpu", torch.float32)


# -- get_whisper_emb -----------------------------------------------------------


@pytest.fixture(scope="module")
def av_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("whisper")
    rng = np.random.RandomState(5)
    for name, frames, seconds in (("a", 10, 0.8), ("b", 7, 1.3),
                                  ("silent", 5, None)):
        tvio.write_video(str(d / f"{name}.mp4"), rng.randint(
            0, 255, (frames, 24, 32, 3), dtype=np.uint8), fps=8)
        if seconds:
            wavfile.write(str(d / f"{name}.wav"), 16000, (
                8000 * rng.randn(int(16000 * seconds))).astype(np.int16))
    return d


def test_get_whisper_emb_matches_jax(av_dir, monkeypatch, tmp_path, capsys):
    argv = ["--video_dir", str(av_dir), "--audio_blocks", "6"]
    monkeypatch.setattr(sys, "argv", ["get_whisper_emb.py"] + argv + [
        "--output_dir", str(tmp_path / "j")])
    jwhisper.main()
    assert get_whisper_emb.main(argv + ["--output_dir",
                                        str(tmp_path / "p")]) == 0
    out = capsys.readouterr().out
    assert out.count("skip (no wav)") == 2
    for name, frames in (("a", 10), ("b", 7)):
        got = np.load(tmp_path / "p" / f"{name}.npy")
        want = np.load(tmp_path / "j" / f"{name}.npy")
        assert got.shape == (frames, 6, 384) and got.dtype == want.dtype
        assert np.array_equal(got, want)
    assert not (tmp_path / "p" / "silent.npy").exists()


def test_get_whisper_emb_args_match_jax(monkeypatch):
    argv = ["--video_dir", "v", "--fps", "30", "--audio_blocks", "10"]
    want = _jax_args(monkeypatch, jwhisper, argv)
    got = get_whisper_emb.parse_args(argv)
    assert vars(got) == dict(vars(want), device="cuda")
