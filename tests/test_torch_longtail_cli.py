"""The port's long-tail CLIs against the JAX package's root CLIs, run in
this process on the same tiny flagship ``config.json``, reference-named
``.safetensors``, tiny SD-VAE and mp4 (``test_torch_serving_io``'s
files), on the CPU.

* ``cli.evaluate`` against ``evaluate.py``, both in fp32 (one dtype
  argument patched on each side, as ``test_torch_serving_cli.py`` does),
  the JAX draws recorded and replayed, with LPIPS weights the test writes
  under torchvision's and the LPIPS heads' names: PSNR within 1e-3 dB,
  SSIM and LPIPS within 1e-4 (the clips agree to fp32 rounding over two
  VAEs and two Euler steps), a broken file reported as ``FAILED`` and
  left out of ``num_videos``;
* ``cli.frequency_filter_decode`` against ``frequency_filter_decode.py``,
  ``fft`` and ``wavelet``, the VAE in fp32 on both sides: the frames each
  hands its mp4 writer within one level (99% equal);
* ``cli.diff_motion_filter`` against ``diff_motion_filter.py``, numpy's
  global generator seeded alike: the PNG files byte for byte;
* ``cli.build_index`` against ``build_index.py``: the ``.pkl`` lists
  equal;
* ``cli.convert_checkpoint`` against ``convert_checkpoint.py`` (``amd``,
  ``amd_new``, ``vae`` and ``a2m``): the same numbers of keys used,
  missing and unused, the written AMD_N checkpoint served by
  ``cli.common.load_amd``, and ``--strict``.
"""

import json
import os
import pickle
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

import build_index as jbuild
import convert_checkpoint as jconvert
import diff_motion_filter as jdiff
import evaluate as jevaluate
import frequency_filter_decode as jfreqdec
import test_torch_serving as common
from hivae_tpu import losses as jlosses
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import vae as jvae
from hivae_tpu.utils import misc as jmisc
from hivae_tpu_torch.cli import amd_inference, build_index, convert_checkpoint
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import diff_motion_filter, evaluate
from hivae_tpu_torch.cli import frequency_filter_decode as freqdec
from hivae_tpu_torch.losses.lpips import LPIPS
from test_torch_serving_cli import (_args, _replay, dtype, jax_cli,  # noqa
                                    written)
from test_torch_serving_io import (SIZE, W, amd,  # noqa: F401
                                   serving_files, tiny_cli_vae, tiny_vae)
from test_torch_serving_pipelines import _same_uint8


def _run(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    return module.main()


# -- cli.evaluate ----------------------------------------------------------------


@pytest.fixture
def lpips_files(tmp_path):
    """LPIPS weights from seed 0 under torchvision's VGG16 names (with a
    classifier key neither side uses) and the LPIPS heads' names."""
    torch.manual_seed(0)
    state = LPIPS().state_dict()
    vgg = {k[len("net."):]: v.contiguous() for k, v in state.items()
           if k.startswith("net.")}
    vgg["classifier.0.weight"] = torch.zeros(4, 4)
    head = {f"lin{k}.model.1.weight": state[f"lin{k}.weight"].abs()
            for k in range(5)}
    safetensors.torch.save_file(vgg, str(tmp_path / "vgg16.safetensors"))
    safetensors.torch.save_file(head, str(tmp_path / "head.safetensors"))
    return ["--lpips_vgg", str(tmp_path / "vgg16.safetensors"),
            "--lpips_head", str(tmp_path / "head.safetensors")]


def test_evaluate_cli_matches_jax(serving_files, tiny_cli_vae, jax_cli,
                                  lpips_files, monkeypatch, tmp_path, capsys):
    draws, first = [], []
    sample_jit = jamd.sample_jit

    def marked(*a, **k):
        jax.effects_barrier()
        first.append(len(draws))
        return sample_jit(*a, **k)
    monkeypatch.setattr(jamd, "sample_jit", marked)
    # the JAX CLI initialises LPIPS eagerly, op by op: jit it whole
    lpips_cls = jlosses.LPIPS
    monkeypatch.setattr(jlosses, "LPIPS", type("LPIPS", (lpips_cls,), {
        "init": lambda self, *a: jax.jit(lambda *b: lpips_cls.init(
            self, *b))(*a)}))
    argv = _args(serving_files, "--video_dir",
                 str(serving_files / "videos"), "--sample_step", "2",
                 *lpips_files)
    with common.recorded_draws(monkeypatch) as draws:
        _run(jevaluate, argv + ["--output_json", str(tmp_path / "j.json")],
             monkeypatch)
    jout = capsys.readouterr().out
    replay = _replay(monkeypatch, draws[first[0]:])
    got = evaluate.main(argv + ["--output_json", str(tmp_path / "p.json"),
                                "--device", "cpu"])
    pout = capsys.readouterr().out
    assert not replay.replay
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "p.json").read_text()) == got
    assert set(got) == set(want) and got["num_videos"] == \
        want["num_videos"] == 1
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= 1e-3
    assert got["psnr_std"] == want["psnr_std"] == 0.0
    for key in ("ssim_mean", "lpips_mean"):
        assert abs(got[key] - want[key]) <= 1e-4, key
    for out in (jout, pout):
        assert re.search(r"FAILED .*broken\.mp4", out)


def test_evaluate_without_lpips(serving_files, tiny_cli_vae, tmp_path):
    got = evaluate.main(_args(serving_files, "--video_dir",
                              str(serving_files / "videos"),
                              "--sample_step", "1", "--max_videos", "1",
                              "--device", "cpu"))
    assert got["lpips_mean"] is None and got["num_videos"] == 1
    assert np.isfinite(got["psnr_mean"]) and np.isfinite(got["ssim_mean"])


# -- cli.frequency_filter_decode -------------------------------------------------


@pytest.mark.parametrize("mode,bands", [("fft", ("low", "high")),
                                        ("wavelet", ("ll", "hl", "lh", "hh"))])
def test_frequency_filter_decode_matches_jax(serving_files, tiny_cli_vae,
                                             jax_cli, written, monkeypatch,
                                             tmp_path, mode, bands):
    tiny = jvae.AutoencoderKL
    monkeypatch.setattr(jvae, "AutoencoderKL",
                        lambda dtype=jnp.float32: tiny(dtype))
    argv = ["--video_path", str(serving_files / "videos" / "a.mp4"),
            "--vae_ckpt", str(serving_files / "vae.safetensors"),
            "--frames", str(W), "--mode", mode]
    _run(jfreqdec, argv + ["--output_dir", str(tmp_path / "j")], monkeypatch)
    paths = freqdec.main(argv + ["--output_dir", str(tmp_path / "p"),
                                 "--size", str(SIZE), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == [
        f"a_{mode}_{b}.mp4" for b in bands]
    for b in bands:
        name = f"a_{mode}_{b}.mp4"
        _same_uint8(written["port"][str(tmp_path / "p" / name)],
                    written["jax"][str(tmp_path / "j" / name)])


# -- cli.diff_motion_filter ------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--two_sample"]],
                         ids=["one", "two_sample"])
def test_diff_motion_filter_matches_jax(serving_files, monkeypatch, tmp_path,
                                        extra):
    argv = ["--video_path", str(serving_files / "videos" / "a.mp4"),
            "--frames_apart", "4", "--s_window_sizes", "16", "32",
            "--direction_thresholds", "0.4", "--max_white_windows", "3",
            *extra]
    np.random.seed(0)
    _run(jdiff, argv + ["--output_dir", str(tmp_path / "j")], monkeypatch)
    np.random.seed(0)
    written_files = diff_motion_filter.main(
        argv + ["--output_dir", str(tmp_path / "p")])
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.path.basename(p) for p in written_files) == names
    assert len(names) == (6 if extra else 4)
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n


def test_two_sample_mask_matches_jax():
    rng = np.random.RandomState(1)
    cam1 = (rng.rand(32, 32) > 0.3).astype(np.float64)
    cam2 = cam1.copy()
    cam2[:8, :8] = 0
    for max_white in (64, 5):
        want = jdiff.two_sample_mask(cam1, cam2, 4, max_white,
                                     np.random.RandomState(2))
        got = diff_motion_filter.two_sample_mask(cam1, cam2, 4, max_white,
                                                 np.random.RandomState(2))
        np.testing.assert_array_equal(got, want)


# -- cli.build_index -------------------------------------------------------------


def test_build_index_matches_jax(serving_files, monkeypatch, tmp_path):
    videos, emb, pose = (tmp_path / n for n in ("videos", "emb", "pose"))
    for d in (videos, emb, pose):
        d.mkdir()
    src = serving_files / "videos" / "a.mp4"
    for i in range(6):
        (videos / ("sub" if i % 2 else "")).mkdir(exist_ok=True)
        shutil.copy(src, videos / ("sub" if i % 2 else "") / f"v{i}.mp4")
        if i != 3:   # one video without an embedding
            np.save(emb / (f"v{i}_emb.npy" if i == 1 else f"v{i}.npy"),
                    np.zeros(2))
        shutil.copy(src, pose / f"v{i}.mp4")
    (videos / "broken.mp4").write_bytes(b"not a video")
    argv = ["--video_dir", str(videos), "--audio_emb_dir", str(emb),
            "--pose_video_dir", str(pose), "--min_frames", "5",
            "--eval_num", "2", "--seed", "3", "--num_workers", "2"]
    _run(jbuild, argv + ["--output", str(tmp_path / "j.pkl"),
                         "--eval_output", str(tmp_path / "je.pkl")],
         monkeypatch)
    build_index.main(argv + ["--output", str(tmp_path / "p.pkl"),
                             "--eval_output", str(tmp_path / "pe.pkl")])
    for j, p in (("j.pkl", "p.pkl"), ("je.pkl", "pe.pkl")):
        want = pickle.loads((tmp_path / j).read_bytes())
        assert pickle.loads((tmp_path / p).read_bytes()) == want
    assert len(pickle.loads((tmp_path / "p.pkl").read_bytes())) == 3
    # too few frames: every video skipped, an empty train list
    build_index.main(["--video_dir", str(videos), "--output",
                      str(tmp_path / "none.pkl")])
    assert pickle.loads((tmp_path / "none.pkl").read_bytes()) == []


# -- cli.convert_checkpoint ------------------------------------------------------


def _report(text):
    m = re.search(r"converted: (\d+) keys used, (\d+) \w+ \w+ missing, "
                  r"(\d+) \w+ keys unused", text)
    return tuple(int(x) for x in m.groups())


def _convert_sources(kind, files, tmp_path):
    """(.safetensors, config) of ``kind``: the serving files' AMD_N and VAE;
    for ``amd`` a tiny dual-encoder ``AMDModel``, for ``a2m`` a tiny audio
    A2M head, each from seed 0 under its reference names."""
    if kind in ("amd_new", "vae"):
        return (files / ("vae.safetensors" if kind == "vae"
                         else "amd.safetensors"), files / "config.json")
    from test_torch_a2m import TINY as A2M_TINY
    from test_torch_amd_family import TINY as AMD_TINY
    from test_torch_serving_io import _reference_named
    from hivae_tpu_torch.models import a2m as ta2m
    from hivae_tpu_torch.models import amd as tamd

    torch.manual_seed(0)
    if kind == "amd":
        cfg = tamd.AMDConfig(**AMD_TINY)
        spec, model = cfg.to_dict(), tamd.AMDModel(cfg, device="cpu")
        state = _reference_named(model.state_dict(), cfg.image_patch_size)
    else:
        spec = {"model": A2M_TINY}
        state = ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**A2M_TINY),
                                            device="cpu").state_dict()
    safetensors.torch.save_file({k: v.contiguous() for k, v in
                                 state.items()}, str(tmp_path / "m.st"))
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    return tmp_path / "m.st", tmp_path / "spec.json"


@pytest.mark.parametrize("kind", ["amd", "amd_new", "vae", "a2m"])
def test_convert_checkpoint_matches_jax(serving_files, amd, tiny_cli_vae,
                                        jax_cli, monkeypatch, tmp_path,
                                        capsys, kind):
    tiny = jvae.AutoencoderKL
    monkeypatch.setattr(jvae, "AutoencoderKL",
                        lambda dtype=jnp.float32: tiny(dtype))
    monkeypatch.setattr(jmisc, "init_on_cpu",
                        lambda fn, *a: jax.jit(lambda: fn(*a))())
    src, config = _convert_sources(kind, serving_files, tmp_path)
    argv = ["--kind", kind, "--src", str(src), "--config", str(config)]
    _run(jconvert, argv + ["--dst", str(tmp_path / "j")], monkeypatch)
    want = _report(capsys.readouterr().out)
    report = convert_checkpoint.main(argv + ["--dst", str(tmp_path / "p"),
                                             "--device", "cpu"])
    got = _report(capsys.readouterr().out)
    assert got == want
    assert (len(report["missing"]), len(report["unused"])) == got[1:]
    assert os.listdir(tmp_path / "p") == ["checkpoint-0"]
    if kind == "amd_new":
        served = cli_common.load_amd(_served_args(
            serving_files, tmp_path / "p"), "cpu")
        for k, v in amd[2].state_dict().items():
            assert torch.equal(served.state_dict()[k], v), k


def _served_args(files, ckpt):
    """``cli.amd_inference``'s arguments serving ``ckpt``."""
    return amd_inference.parse_args(
        ["--amd_config", str(files / "config.json"), "--amd_ckpt", str(ckpt),
         "--video_dir", ".", "--video_frames", str(W)])


def test_convert_checkpoint_strict_refuses_missing_keys(serving_files,
                                                        tmp_path):
    partial = {k: v for k, v in safetensors.torch.load_file(
        str(serving_files / "amd.safetensors")).items()
        if "diffusion_transformer" not in k}
    safetensors.torch.save_file(partial, str(tmp_path / "part.safetensors"))
    argv = ["--kind", "amd_new", "--config",
            str(serving_files / "config.json"), "--src",
            str(tmp_path / "part.safetensors"), "--dst", str(tmp_path / "o"),
            "--device", "cpu"]
    with pytest.raises(KeyError, match="missing"):
        convert_checkpoint.main(argv + ["--strict"])
    assert convert_checkpoint.main(argv)["missing"]
