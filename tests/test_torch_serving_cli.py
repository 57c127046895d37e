"""The port's three inference CLIs against the JAX package's root CLIs
(``amd_inference.py``, ``amd_inference_single.py``, ``extract_motion.py``),
run on the same ``config.json``, reference-named ``.safetensors`` of the
tiny flagship AMD_N, tiny SD-VAE ``.safetensors`` and mp4, on the CPU:
frame sampling, pixel size, chunking, checkpoint loading, draws and output.

Both CLIs serve in bf16. The comparisons run both packages' models in
fp32 instead (one dtype argument on each side), so that the glue is held
to the pipelines' own rule: uint8 frames at most one level apart, equal on
99% of the values (``test_torch_serving_pipelines.py``), motion tokens
within ``common.TOL``. ``extract_motion`` also runs in the CLIs' bf16:
tokens within ``BF16_TOL`` of their largest magnitude (about five bf16
steps of 2^-8 there: the frameworks round each layer's sums in other
places, and the rounding errors add up in absolute terms, on the scale of
the tensor, not of each element), and the saved files differ in dtype
only: the JAX CLI saves bf16, which numpy reads back as raw 2-byte voids
unless ``ml_dtypes`` is at hand; the port widens the same bf16 values to
float32, exactly.

The JAX CLIs build the SD-VAE of the published configuration and read
256² frames, the flagship's size; here their VAE is the tiny one and their
frame size the tiny config's, which is what the port's CLIs derive from
the config. The JAX draws are recorded as they are made and replayed into
the port (``test_torch_serving.recorded_draws``). The frames each CLI
hands to its mp4 writer are compared, not the decoded files, so the codec
does not enter the comparison.
"""

import sys
from functools import partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import amd_inference as jinfer
import amd_inference_single as jsingle
import extract_motion as jextract
import test_torch_serving as common
from hivae_tpu import pipelines as jpipelines
from hivae_tpu.data import video as jvio
from hivae_tpu.models import vae as jvae
from hivae_tpu.utils import cache as jcache
from hivae_tpu.utils import misc as jmisc
from hivae_tpu_torch.cli import amd_inference, amd_inference_single
from hivae_tpu_torch.cli import common as cli_common
from hivae_tpu_torch.cli import extract_motion
from hivae_tpu_torch.data import video as tvio
from hivae_tpu_torch.models import amd as tamd
from test_torch_serving_pipelines import _same_uint8
from test_torch_serving_io import (SIZE, VAE_CFG, W, amd,  # noqa: F401
                                   serving_files, tiny_cli_vae, tiny_vae)

BF16_TOL = 0.02


@pytest.fixture
def dtype(request, monkeypatch):
    """The dtype both CLIs serve in: fp32 (both packages' models and VAEs
    built in fp32 in place of bf16) unless a test asks for their own
    bf16."""
    dtype = getattr(request, "param", "fp32")
    if dtype == "fp32":
        jload = jinfer.load_amd
        for mod in (jinfer, jsingle):
            monkeypatch.setattr(mod, "load_amd",
                                lambda args, dtype: jload(args, jnp.float32))
        for name in ("load_amd", "build_vae"):
            monkeypatch.setattr(cli_common, name, partial(
                getattr(cli_common, name), dtype=torch.float32))
    return dtype


@pytest.fixture
def jax_cli(monkeypatch, dtype):
    """Run a root JAX CLI's ``main`` on ``argv`` with the tiny SD-VAE (in
    ``dtype``) and the tiny config's frame size, and without its
    compilation cache, its initialisations compiled whole (eager they
    compile op by op; the checkpoints replace what they make). Returns the
    draws its pipeline made (those of the initialisations, which come
    first, left out)."""
    monkeypatch.setattr(jcache, "enable_compile_cache", lambda *a: None)
    monkeypatch.setattr(jmisc, "init_on_cpu", lambda fn: jax.jit(fn)())
    vae_cls = jvae.AutoencoderKL
    monkeypatch.setattr(jvae, "AutoencoderKL", lambda dtype: vae_cls(
        cfg=jvae.VAEConfig(**VAE_CFG),
        dtype=jnp.float32 if fp32 else dtype))
    fp32 = dtype == "fp32"
    transform = jvio.pixel_transform
    monkeypatch.setattr(jvio, "pixel_transform",
                        lambda frames, size=SIZE: transform(frames, size))
    first = []

    def marked(method):
        def run(*a, **k):
            jax.effects_barrier()
            first.append(len(draws))
            return method(*a, **k)
        return run

    for name in ("AMDReconstructionPipeline", "AMDCrossVideoPipeline"):
        cls = getattr(jpipelines, name)
        sub = type(name, (cls,), {m: marked(getattr(cls, m)) for m in (
            "sample", "sample_long", "sample_cross") if hasattr(cls, m)})
        monkeypatch.setattr(jpipelines, name, partial(sub, sample_size=SIZE))

    def run(module, argv):
        nonlocal draws
        monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
        with common.recorded_draws(monkeypatch) as draws:
            module.main()
        return draws[first[0]:] if first else []
    draws = []
    return run


@pytest.fixture
def written(monkeypatch):
    """The frames each package hands to its mp4 writer, by output path."""
    frames = {"jax": {}, "port": {}}
    for side, vio in (("jax", jvio), ("port", tvio)):
        def record(path, video, *a, _vio=vio.write_video, _side=side, **k):
            frames[_side][str(path)] = np.array(video)
            return _vio(path, video, *a, **k)
        monkeypatch.setattr(vio, "write_video", record)
    return frames


def _replay(monkeypatch, draws):
    """The port's CLIs take their draws from the JAX run's record (bf16
    noise widened to float32, exactly, for torch to read)."""
    replay = tamd.SampleDraws(replay=[d.astype(np.float32) for d in draws])
    monkeypatch.setattr(cli_common, "draws", lambda device, seed: replay)
    return replay


def _args(files, *extra):
    return ["--amd_config", str(files / "config.json"),
            "--amd_ckpt", str(files / "amd.safetensors"),
            "--vae_ckpt", str(files / "vae.safetensors"),
            "--video_frames", str(W), *extra]


@pytest.mark.parametrize("extra", [
    ["--solver", "heun"],
    ["--long", "--max_frames", str(W + 2), "--mask_ratio", "0.5",
     "--drop_prev_img"]], ids=["clip", "long"])
def test_amd_inference_cli_matches_jax(serving_files, tiny_cli_vae, jax_cli,
                                       written, monkeypatch, tmp_path,
                                       extra):
    videos = str(serving_files / "videos")
    common_args = _args(serving_files, "--video_dir", videos,
                        "--sample_step", "2", *extra)
    draws = jax_cli(jinfer, common_args + [
        "--output_dir", str(tmp_path / "j")])
    replay = _replay(monkeypatch, draws)
    assert amd_inference.main(common_args + [
        "--output_dir", str(tmp_path / "p"), "--device", "cpu"]) == 1
    assert not replay.replay   # every JAX draw was taken
    want = written["jax"][str(tmp_path / "j" / "a_recon.mp4")]
    got = written["port"][str(tmp_path / "p" / "a_recon.mp4")]
    assert len(written["jax"]) == len(written["port"]) == 1  # broken.mp4
    _same_uint8(got, want)


def test_amd_inference_single_cli_matches_jax(serving_files, tiny_cli_vae,
                                              jax_cli, written, monkeypatch,
                                              tmp_path):
    vid = str(serving_files / "videos" / "a.mp4")
    args = _args(serving_files, "--video_path_1", vid, "--video_path_2",
                 vid, "--sample_step", "2")
    draws = jax_cli(jsingle, args + ["--output_path",
                                     str(tmp_path / "j.mp4")])
    replay = _replay(monkeypatch, draws)
    assert amd_inference_single.main(args + [
        "--output_path", str(tmp_path / "p.mp4"), "--device", "cpu"]) == 0
    assert not replay.replay
    _same_uint8(written["port"][str(tmp_path / "p.mp4")],
                 written["jax"][str(tmp_path / "j.mp4")])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"], indirect=True)
def test_extract_motion_cli_matches_jax(serving_files, tiny_cli_vae, jax_cli,
                                        dtype, tmp_path):
    args = _args(serving_files, "--video_dir",
                 str(serving_files / "videos"), "--chunk_frames", "2")
    jax_cli(jextract, args + ["--output_dir", str(tmp_path / "j")])
    assert extract_motion.main(args + ["--output_dir", str(tmp_path / "p"),
                                       "--device", "cpu"]) == 1
    want = np.load(tmp_path / "j" / "a_motion.npy")
    got = np.load(tmp_path / "p" / "a_motion.npy")
    assert got.dtype == np.float32 and got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, **common.TOL)
        return
    assert want.dtype == np.dtype("V2")   # bf16, saved by ml_dtypes
    want = want.view(ml_dtypes.bfloat16).astype(np.float32)
    # the port's float32 holds bf16 values: widening lost nothing
    assert np.array_equal(got.astype(ml_dtypes.bfloat16).astype(np.float32),
                          got)
    err = np.abs(got - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err
