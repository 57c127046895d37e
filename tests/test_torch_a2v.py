"""Audio-to-video serving with the port against the JAX package, fp32 on
the CPU:

  * ``ImageAudio2VideoPipeline.predict`` (``pipelines/pipeline.py``) on a
    tiny stack (the tiny flagship AMD_N, a tiny SD-VAE and a tiny A2M head
    whose tokens are AMD_N's object tokens) against the JAX pipeline: two
    windows and a ragged tail, ``need_motion_extract_model``, and a long
    audio of seven windows and a tail that generates its full length. The
    JAX draws (per window the A2M start noise, then the AMD one) are
    recorded as they are made and replayed (``test_torch_serving``).
    Latents within ``TOL``: 2e-3 absolute and relative, twice the one-clip
    serving tolerance, since each window starts from the previous
    window's output and carries its difference on;
  * the int8 pipeline (the predicate's threshold lowered to the tiny
    widths on both sides): the three tables hold the JAX pipeline's layers
    and the JAX package's entries bit for bit, the covered float weights
    are stripped, and its routing layer by layer: every DiT layer runs int8
    once a video step and window, every A2M layer once a motion step and
    window, every decoder layer once, and no other;
  * ``data/audio.py`` against the JAX module: the filterbank features,
    ``linear_interpolation``, ``load_whisper_embedding``, and ``read_wav``
    for int16,
    int32, uint8, float and stereo files and resampling (exact);
  * ``data/av_mux.py`` against the JAX module: the AVI written for the
    same frames and wav is byte-identical, directly and through
    ``export_video_with_audio`` without ffmpeg; ``read_wav_segment`` trims
    the same samples at every sample width; ``write_video(audio_path=)``
    writes the file whose path it returns.
"""

import collections
import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import __graft_entry__ as graft
import test_torch_serving as common
from hivae_tpu.data import audio as jaudio
from hivae_tpu.data import av_mux as jmux
from hivae_tpu.models import a2m as ja2m
from hivae_tpu.models import vae as jvae
from hivae_tpu.ops import quant as jq
from hivae_tpu.pipelines import pipeline as jpipe
from hivae_tpu_torch.data import audio as taudio
from hivae_tpu_torch.data import av_mux as tmux
from hivae_tpu_torch.data import video as tvio
from hivae_tpu_torch.models import a2m as ta2m
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.ops import quant as tq
from hivae_tpu_torch.pipelines import ImageAudio2VideoPipeline
from hivae_tpu_torch.pipelines import pipeline as tpipe
from hivae_tpu_torch.utils.params import (flax_quant_table_to_torch,
                                          flax_to_torch)
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_quant import _record_int8_calls

W, R = 4, 2
SIZE, LAT = 32, 16
M, C = 3, 8
VAE_CFG = dict(block_out_channels=(32, 64), layers_per_block=1,
               norm_num_groups=8)
A2M_CFG = dict(audio_inchannel=C, audio_block=M, motion_num_token=4,
               motion_in_channel=32, motion_frames=W, window_size=2,
               encoder_out_dim=16, intermediate_dim=24,
               diffusion_attn_head_dim=16, diffusion_attn_num_heads=2,
               diffusion_num_layers=2)
TOL = dict(atol=2e-3, rtol=2e-3)
STEPS = dict(motion_sample_step=2, video_sample_step=2)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port(params, module):
    module.load_state_dict(flax_to_torch(params), strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def stack():
    """JAX (vae, vae params, amd, amd params, a2m, a2m params) and the
    port's (vae, amd, a2m) on the same parameters."""
    jamd_mod = graft._flagship(tiny=True, frames=W)
    v = jnp.zeros((1, W, 4, LAT, LAT))
    amd_params = random_params(jamd_mod, v, v, v, v, seed=4)
    jvae_mod = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**VAE_CFG))
    vae_params = random_params(jvae_mod, jnp.zeros((1, 3, SIZE, SIZE)),
                               seed=5)
    ja2m_mod = ja2m.A2MModelCrossAttnAudio(cfg=ja2m.A2MConfig(**A2M_CFG))
    motion = jnp.zeros((1, W, 4, 32))
    audio = jnp.zeros((1, W, M, C))
    a2m_params = random_params(ja2m_mod, motion, motion[:, 0], audio=audio,
                               ref_audio=audio[:, 0], seed=6)
    port = (
        _port(vae_params, tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG),
                                             device="cpu")),
        _port(amd_params, tamd.AMDModelNew(tamd.AMDConfig.from_dict(
            jamd_mod.cfg.to_dict()), device="cpu")),
        _port(a2m_params, ta2m.A2MModelCrossAttnAudio(
            ta2m.A2MConfig(**A2M_CFG), device="cpu")))
    return (jvae_mod, vae_params, jamd_mod, amd_params, ja2m_mod,
            a2m_params), port


def _inputs(frames, seed):
    """ref_img (1, 1, 3, SIZE, SIZE) pixels, ref_audio (1, 1, M, C), audio
    (1, frames, M, C)."""
    return (np.tanh(_rand(1, 1, 3, SIZE, SIZE, seed=seed)),
            _rand(1, 1, M, C, seed=seed + 1),
            _rand(1, frames, M, C, seed=seed + 2))


@pytest.mark.parametrize("frames,extract", [(2 * W + 2, False),
                                            (2 * W + 2, True),
                                            (7 * W + 3, False)],
                         ids=["windows_tail", "motion_extract", "long"])
def test_predict_matches_jax(stack, monkeypatch, frames, extract):
    jstack, (vae, amd, a2m) = stack
    x = _inputs(frames, seed=frames + extract)
    jpipe_ = jpipe.ImageAudio2VideoPipeline(
        *jstack, window=W, a2m_ref_num_frame=R, sample_size=SIZE,
        need_motion_extract_model=extract)
    with common.recorded_draws(monkeypatch) as draws:
        want = jpipe_.predict(*map(jnp.asarray, x), key=jax.random.PRNGKey(3),
                              **STEPS)
    windows = -(-frames // W)
    assert [d.shape for d in draws] == [(1, W, 4, 32), (W, 4, LAT, LAT)] * \
        windows
    pipe = ImageAudio2VideoPipeline(vae, amd, a2m, window=W,
                                    a2m_ref_num_frame=R, sample_size=SIZE,
                                    need_motion_extract_model=extract)
    replay = tamd.SampleDraws(replay=draws)
    got = pipe.predict(*map(_t, x), generator=replay, **STEPS)
    assert not replay.replay
    assert got.shape == (1, frames + 1, 4, LAT, LAT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predict_refuses_audio_shorter_than_a_window(stack):
    _, (vae, amd, a2m) = stack
    pipe = ImageAudio2VideoPipeline(vae, amd, a2m, window=W,
                                    a2m_ref_num_frame=R, sample_size=SIZE)
    with pytest.raises(ValueError, match="a window needs 4"):
        pipe.predict(*map(_t, _inputs(W - 1, seed=1)))


def test_pad_ref_matches_jax(stack):
    jstack, (vae, amd, a2m) = stack
    jp = jpipe.ImageAudio2VideoPipeline(*jstack, window=W,
                                        a2m_ref_num_frame=3)
    pipe = ImageAudio2VideoPipeline(vae, amd, a2m, window=W,
                                    a2m_ref_num_frame=3)
    for frames in (1, 3, 5):
        x = _rand(2, frames, 2, 2, seed=frames)
        assert np.array_equal(pipe._pad_ref(_t(x)).numpy(),
                              np.asarray(jp._pad_ref(jnp.asarray(x))))


def _lowered(monkeypatch, min_dim=32):
    """The int8 size predicate at the tiny widths, on both sides."""
    jpred, tpred = jq.default_predicate, tq.default_predicate
    monkeypatch.setattr(jq, "default_predicate",
                        lambda p, k: jpred(p, k, min_dim=min_dim))
    monkeypatch.setattr(tq, "default_predicate",
                        lambda n, w: tpred(n, w, min_dim=min_dim))


def test_int8_tables_and_routing_match_jax(stack, monkeypatch):
    jstack, _ = stack
    _lowered(monkeypatch)
    jp = jpipe.ImageAudio2VideoPipeline(*jstack, window=W,
                                        a2m_ref_num_frame=R, sample_size=SIZE,
                                        quant="int8")
    # fresh port models: the pipeline strips the covered float weights
    vae, amd, a2m = (_port(p, m) for p, m in zip(
        (jstack[1], jstack[3], jstack[5]),
        (tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG), device="cpu"),
         tamd.AMDModelNew(tamd.AMDConfig.from_dict(jstack[2].cfg.to_dict()),
                          device="cpu"),
         ta2m.A2MModelCrossAttnAudio(ta2m.A2MConfig(**A2M_CFG),
                                     device="cpu"))))
    pipe = ImageAudio2VideoPipeline(vae, amd, a2m, window=W,
                                    a2m_ref_num_frame=R, sample_size=SIZE,
                                    quant="int8")
    tables = {"dit": (pipe.quant_table, jp.quant_table),
              "vae": (pipe.vae_quant_table, jp.vae_quant_table),
              "a2m": (pipe.a2m_quant_table, jp.a2m_quant_table)}
    params = {"dit": jstack[3], "vae": jstack[1], "a2m": jstack[5]}
    for scope, (got, piped) in tables.items():
        # the JAX pipeline's layers; their entries bit for bit against
        # the JAX table built outside jit (under jit XLA may round a
        # scale's division in its last bit otherwise)
        assert got.keys() == flax_quant_table_to_torch(
            jax.device_get(piped)).keys() and got, scope
        want = flax_quant_table_to_torch(jq.quantize_params(
            params[scope], scope=tpipe.QUANT_SCOPES[scope]))
        for name, entry in want.items():
            for k, v in entry.items():
                assert torch.equal(got[name][k], v), (scope, name, k)
    model = {"dit": amd, "vae": vae, "a2m": a2m}
    for scope, (table, _) in tables.items():
        for name in table:
            assert model[scope].get_submodule(name).weight.numel() == 0

    frames = 2 * W + 1
    windows = -(-frames // W)
    calls, _ = _record_int8_calls(monkeypatch, [t for t, _ in
                                                tables.values()])
    out = pipe.sample_pixels(
        np.tanh(_rand(3, SIZE, SIZE, seed=9)), _rand(frames + 1, M, C,
                                                     seed=10),
        generator=torch.Generator().manual_seed(0), **STEPS)
    assert out.shape == (frames + 1, 3, SIZE, SIZE) and out.dtype == \
        torch.uint8
    steps = {"dit": STEPS["video_sample_step"] * windows,
             "a2m": STEPS["motion_sample_step"] * windows, "vae": 1}

    def runs(name):
        # the tokens decode through the object stream alone: the camera
        # joint blocks do not run, the object motion embedding runs on the
        # source and the target tokens
        if ".camera_transformer_blocks." in name:
            return 0
        return 2 if name.endswith("object_motion_patch_embed") else 1
    want = collections.Counter({name: steps[scope] * runs(name)
                                for scope, (table, _) in tables.items()
                                for name in table})
    assert calls == +want


def test_int8_a2m_table_may_be_empty(stack, monkeypatch):
    """A head none of whose layers the int8 predicate takes serves in its
    compute dtype, with a warning, as the JAX pipeline's ``allow_empty``
    does (here the predicate takes the DiT's and the decoder's layers at
    the tiny widths and none of the head's)."""
    _, (vae, amd, a2m) = stack
    tpred = tq.default_predicate
    monkeypatch.setattr(tq, "default_predicate", lambda n, w: (
        not n.startswith("diffusion.") and tpred(n, w, min_dim=32)))
    with pytest.warns(UserWarning, match="no a2m layers"):
        pipe = ImageAudio2VideoPipeline(copy.deepcopy(vae),
                                        copy.deepcopy(amd), a2m, window=W,
                                        a2m_ref_num_frame=R, quant="int8")
    assert pipe.a2m_quant_table is None
    assert pipe.quant_table and pipe.vae_quant_table
    assert all(p.numel() for p in a2m.parameters())


# -- data/audio.py -------------------------------------------------------------


def _wave(n=8000, seed=0):
    t = np.arange(n) / 16000.0
    rng = np.random.RandomState(seed)
    return (0.5 * np.sin(2 * np.pi * 220 * t) +
            0.1 * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("only_last", [True, False])
def test_filterbank_features_match_jax(only_last):
    wav = _wave()
    kw = dict(features_per_frame=384 if only_last else 40,
              only_last_features=only_last)
    want = jaudio.AudioProcessor(**kw)(wav, 13)
    got = taudio.AudioProcessor(**kw)(wav, 13)
    assert got.shape == want.shape == (13, 384 if only_last else 520)
    assert np.array_equal(got, want)


def test_linear_interpolation_and_embeddings_match_jax(tmp_path):
    x = torch.from_numpy(_rand(2, 7, 5, seed=3))
    for n in (1, 4, 7, 19):
        assert torch.equal(taudio.linear_interpolation(x, n),
                           jaudio.linear_interpolation(x, n))
    emb = _rand(6, 4, 3, seed=4)
    np.save(tmp_path / "e.npy", emb.astype(np.float64))
    torch.save(torch.from_numpy(emb).double(), tmp_path / "e.pt")
    torch.save(emb, tmp_path / "a.pt")
    for name in ("e.npy", "e.pt", "a.pt"):
        got = taudio.load_whisper_embedding(str(tmp_path / name))
        want = jaudio.load_whisper_embedding(str(tmp_path / name))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["int16", "int32", "uint8", "float32",
                                  "stereo", "resample_8k", "resample_44k"])
def test_read_wav_matches_jax(tmp_path, kind):
    wav = _wave(3000, seed=2)
    rate = {"resample_8k": 8000, "resample_44k": 44100}.get(kind, 16000)
    data = {"int16": (wav * 32767).astype(np.int16),
            "int32": (wav * 2 ** 31 * 0.99).astype(np.int32),
            "uint8": (wav * 127 + 128).astype(np.uint8),
            "float32": wav,
            "stereo": np.stack([(wav * 32767).astype(np.int16),
                                (-wav * 16000).astype(np.int16)], 1)}.get(
        kind, (wav * 32767).astype(np.int16))
    path = str(tmp_path / f"{kind}.wav")
    wavfile.write(path, rate, data)
    got, want = taudio.read_wav(path), jaudio.read_wav(path)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    if rate != 16000:
        assert len(got) == int(3000 * 16000 / rate)


# -- data/av_mux.py ------------------------------------------------------------


def _frames(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 24, 32, 3), dtype=np.uint8)


def _wav_file(path, seconds, rate=16000, width=2, channels=1):
    import wave
    n = int(seconds * rate)
    rng = np.random.RandomState(3)
    raw = {1: rng.randint(0, 256, n * channels).astype(np.uint8),
           2: rng.randint(-2 ** 15, 2 ** 15, n * channels).astype("<i2"),
           4: rng.randint(-2 ** 31, 2 ** 31 - 1, n * channels,
                          dtype=np.int64).astype("<i4")}[width]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())
    return str(path)


@pytest.mark.parametrize("width,channels", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_read_wav_segment_matches_jax(tmp_path, width, channels):
    path = _wav_file(tmp_path / "a.wav", 0.5, width=width,
                     channels=channels)
    for start, duration in ((0.0, None), (0.1, 0.2), (0.45, 1.0),
                            (0.6, None)):
        rate, got = tmux.read_wav_segment(path, start, duration)
        want_rate, want = jmux.read_wav_segment(path, start, duration)
        assert rate == want_rate == 16000
        assert got.dtype == want.dtype == np.int16
        assert np.array_equal(got, want)
        expect = min(8000, round(start * 16000) + (8000 if duration is None
                                                   else round(duration *
                                                              16000)))
        assert got.shape == (max(expect - round(start * 16000), 0),
                             channels)


def test_avi_is_byte_identical_to_jax(tmp_path, monkeypatch):
    frames = _frames()
    rate, pcm = jmux.read_wav_segment(_wav_file(tmp_path / "a.wav", 0.3))
    tmux.write_avi_with_audio(str(tmp_path / "p.avi"), frames, 25.0, rate,
                              pcm)
    jmux.write_avi_with_audio(str(tmp_path / "j.avi"), frames, 25.0, rate,
                              pcm)
    got = (tmp_path / "p.avi").read_bytes()
    assert got == (tmp_path / "j.avi").read_bytes()
    assert got[:4] == b"RIFF" and b"auds" in got and b"01wb" in got

    # without ffmpeg, export_video_with_audio writes the AVI in both
    monkeypatch.setattr(shutil, "which", lambda name: None)
    wav = str(tmp_path / "a.wav")
    chw = frames.transpose(0, 3, 1, 2)
    p = tmux.export_video_with_audio(str(tmp_path / "p.mp4"), chw, 20.0,
                                     wav, 0.05)
    j = jmux.export_video_with_audio(str(tmp_path / "j.mp4"), chw, 20.0,
                                     wav, 0.05)
    assert p.endswith("p.avi") and j.endswith("j.avi")
    assert open(p, "rb").read() == open(j, "rb").read()


def test_write_video_with_audio_writes_the_path_it_returns(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    wav = _wav_file(tmp_path / "a.wav", 1.0)
    frames = _frames(8, seed=1)
    out = tvio.write_video(str(tmp_path / "v.mp4"), frames, fps=8,
                           audio_path=wav)
    assert out == str(tmp_path / "v.avi") and os.path.exists(out)
    import cv2
    cap = cv2.VideoCapture(out)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, first = cap.read()
    cap.release()
    assert ok and n == 8 and first.shape == (24, 32, 3)
    # the whole second of audio in the container, 16-bit mono
    data = open(out, "rb").read()
    assert data.count(b"01wb") == 2 * 8   # a chunk and its index entry
    # without audio_path: the mp4 itself
    plain = tvio.write_video(str(tmp_path / "s.mp4"), frames, fps=8)
    assert plain == str(tmp_path / "s.mp4") and os.path.exists(plain)
