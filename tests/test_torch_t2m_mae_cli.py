"""The T2M, MAE and text-embedding CLIs of the port (``cli/train_t2m.py``,
``cli/train_mae.py``, ``cli/get_clip_emb.py``) against the JAX package's,
fp32 on the CPU, on the tiny stack of ``test_torch_a2v`` (the tiny
flagship AMD_N: 4 object tokens of 32 channels, camera tokens of 16; a
tiny SD-VAE; 32 x 32 frames, 16 x 16 latents):

  * ``T2MTrainer``'s step against the JAX CLI's ``train_step``, composed
    from the package's functions as ``train_t2m.py`` composes it, the six
    draws (the posterior noise of the clip's, the reference's, the grey
    clip's and the grey reference's encode, the head's timestep and flow
    noise) drawn with numpy and replayed into both: loss 1e-5 relative,
    ``grad_norm`` 1e-4; ``MAETrainer``'s against ``train_mae.py``'s (the
    encode's noise and the masking draw replayed) the same;
  * which head configurations the JAX CLI trains against the tiny AMD_N,
    from ``jax.eval_shape`` of its own initialisation and step: the port's
    ``check_pairing`` refuses, with a ``ValueError`` naming both counts,
    exactly those where it fails (the default ``object_token_num`` 16
    against 4 tokens; wider object or camera tokens than the AMD gives; a
    reference grid off the latents); and the frozen model: the JAX CLI
    builds ``AMDModelNew`` only for AMD_N (``amd_inference.load_amd``,
    its parameters from ``eval_shape``), the port refuses every other type
    naming the cause, and a label past ``num_classes``;
  * the argument parsers against the JAX CLIs' (the port adds
    ``--device``, ``--resume_training`` and ``--dist_backend``);
  * both training CLIs end to end on synthetic mp4s (T2M on a tree of two
    class directories): 2 steps with a checkpoint each step, T2M's config
    written, a resume to step 3, and the ``SystemExit`` of a dataset that
    yields no batch;
  * ``cli.get_clip_emb`` writes the same files, with the same bits, as
    ``get_clip_emb.py`` (pooled and ``--save_sequence``).
"""

import json
import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import amd_inference as jinfer
import get_clip_emb as jclip
import train_mae as jtrain_mae
import train_t2m as jtrain_t2m
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import mae as jmae
from hivae_tpu.models import t2m as jt2m
from hivae_tpu.models import vae as jvae
from hivae_tpu_torch.cli import get_clip_emb, train_mae, train_t2m
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import mae as tmae
from hivae_tpu_torch.models import t2m as tt2m
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_a2v import SIZE, W, stack  # noqa: F401
from test_torch_a2v_cli import files, fp32  # noqa: F401
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_data import _frames, _write_mp4
from test_torch_training import _replay

N = 2
LAT = SIZE // 2
KEY = jax.random.PRNGKey(0)
# a tiny head that pairs with the tiny AMD_N (4 object tokens of 32, camera
# tokens of 16 channels) and its 16 x 16 latents
T2M_CFG = dict(label_dim=16, num_classes=3, motion_dim=16, refimg_width=LAT,
               refimg_height=LAT, refimg_patch_size=2, refimg_dim=4,
               time_embed_dim=32, attention_head_dim=8, num_attention_heads=2,
               num_layers=1, camera_token_num=4, camera_channel=8,
               object_token_num=4, object_channel=16)
MAE_TINY = dict(img_size=(LAT, LAT), patch_size=4, embed_dim=32, depth=1,
                num_heads=2, decoder_embed_dim=16, decoder_depth=1,
                decoder_num_heads=2)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


_JIT = {}


def _jax_encode(jstack):
    """The JAX side's posterior-sample encode (its noise replayed into
    ``jax.random.normal``) and AMD ``encode``, jitted once a module."""
    jvae_mod, vparams, jamd_mod, amd_params = jstack[:4]
    if id(vparams) not in _JIT:
        @jax.jit
        def encode(x, noise):
            with _replay(normal=[noise]):
                return jvae.vae_encode(jvae_mod, vparams, x, KEY)

        motion = jax.jit(lambda *z: jamd_mod.apply(amd_params, *z,
                                                   method="encode"))
        _JIT[id(vparams)] = encode, motion
    return _JIT[id(vparams)]


# -- the T2M step -------------------------------------------------------------


def _t2m_batch(seed):
    rng = np.random.RandomState(seed)
    pix = lambda: np.clip(rng.randn(N, W, 3, SIZE, SIZE) * 0.5,  # noqa: E731
                          -1, 1).astype(np.float32)
    video, grey = pix(), pix()
    return {"videos": video, "ref_img": np.repeat(video[:, :1], W, axis=1),
            "grey_videos": grey,
            "ref_grey_img": np.repeat(grey[:, :1], W, axis=1),
            "label": np.array([2, 0], np.int32)}


def _t2m_draws(seed):
    rng = np.random.RandomState(seed)
    out = {k: rng.randn(N * W, 4, LAT, LAT).astype(np.float32)
           for k in ("video", "ref", "grey", "ref_grey")}
    out["timestep"] = np.array([137, 820], np.int32)
    out["noise"] = rng.randn(N * W, 4, 16).astype(np.float32)
    return out


def _jax_t2m_step(jstack, jmod, params, batch, d):
    """``train_t2m.py``'s ``train_step`` (its six keys replaced by the
    replayed draws) -> (loss, grad_norm)."""
    encode, amd_encode = _jax_encode(jstack)
    cfg = jmod.cfg
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    video_z = encode(b["videos"], d["video"])
    ref_z = encode(b["ref_img"], d["ref"])
    grey_z = encode(b["grey_videos"], d["grey"])
    ref_grey_z = encode(b["ref_grey_img"], d["ref_grey"])
    cam_t, _, obj_t = amd_encode(video_z, ref_z, grey_z, ref_grey_z)
    cam_small = cam_t[:, :, :cfg.camera_token_num, :cfg.camera_channel]
    obj_small = obj_t[:, :cfg.object_token_num, :cfg.object_channel]

    def loss_fn(p):
        with _replay(normal=[d["noise"]]):
            out = jmod.apply(p, cam_small, obj_small, b["label"], ref_z,
                             jnp.asarray(d["timestep"]).astype(jnp.float32),
                             rngs={"noise": KEY})
        return jmod.apply(p, out, method="loss")
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), float(optax.global_norm(grads))


def _args(module, extra):
    return module.parse_args(["--amd_config", "c", "--amd_ckpt", "k",
                              "--video_dir", "v", "--mp", "no"] + extra)


def test_t2m_step_matches_jax_train_step(stack, tmp_path):  # noqa: F811
    jstack, (vae, amd, _) = stack
    jmod = jt2m.Label2MotionDiffusionDecoder(cfg=jt2m.T2MConfig(**T2M_CFG))
    cam = jnp.zeros((1, W, 4, 8))
    obj = jnp.zeros((W, 4, 16))
    params = random_params(jmod, cam, obj, jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, W, 4, LAT, LAT)), jnp.zeros((1,)),
                           seed=21)
    head = tt2m.Label2MotionDiffusionDecoder(tt2m.T2MConfig(**T2M_CFG),
                                             device="cpu")
    head.load_state_dict(flax_to_torch(params), strict=True)
    batch, d = _t2m_batch(22), _t2m_draws(23)
    want_loss, want_norm = _jax_t2m_step(jstack, jmod, params, batch, d)
    trainer = train_t2m.T2MTrainer(head.train(), amd, vae, _args(
        train_t2m, ["--max_train_steps", "10"]), str(tmp_path))
    m = trainer.train_step(batch, train_t2m.T2MDraws(
        **{k: _t(v) for k, v in d.items()}))
    assert set(m) == {"loss", "grad_norm"}
    np.testing.assert_allclose(m["loss"].item(), want_loss, rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), want_norm, rtol=1e-4)
    assert trainer.state.step == 1


# -- which configurations train ------------------------------------------------


def _jax_t2m_trains(jstack, over, latent=LAT):
    """True where ``train_t2m.py``'s initialisation and step trace against
    the tiny AMD_N's ``encode`` shapes (``jax.eval_shape``: nothing
    runs)."""
    _, _, jamd_mod, amd_params = jstack[:4]
    cfg = jt2m.T2MConfig(**dict(T2M_CFG, **over))
    model = jt2m.Label2MotionDiffusionDecoder(cfg=cfg)
    z = jax.ShapeDtypeStruct((1, W, 4, latent, latent), jnp.float32)
    if latent == LAT:
        cam_t, _, obj_t = jax.eval_shape(lambda *x: jamd_mod.apply(
            amd_params, *x, method="encode"), z, z, z, z)
    else:   # the AMD model is sized to LAT; only the head sees other grids
        cam_t, _, obj_t = jax.eval_shape(lambda *x: jamd_mod.apply(
            amd_params, *x, method="encode"), *([jax.ShapeDtypeStruct(
                (1, W, 4, LAT, LAT), jnp.float32)] * 4))
    try:
        init = jax.eval_shape(lambda: model.init(
            {"params": KEY, "noise": KEY},
            jnp.zeros((1, W, cfg.camera_token_num, cfg.camera_channel)),
            jnp.zeros((W, cfg.object_token_num, cfg.object_channel)),
            jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, W, cfg.refimg_dim, cfg.refimg_height,
                       cfg.refimg_width)), jnp.zeros((1,))))

        def step(p, cam, obj, ref):
            out = model.apply(
                p, cam[:, :, :cfg.camera_token_num, :cfg.camera_channel],
                obj[:, :cfg.object_token_num, :cfg.object_channel],
                jnp.zeros((1,), jnp.int32), ref, jnp.zeros((1,)),
                rngs={"noise": KEY})
            return model.apply(p, out, method="loss")
        jax.eval_shape(jax.grad(step), init, cam_t, obj_t, z)
    except (TypeError, ValueError, flax.errors.FlaxError) as e:
        return False, str(e)
    return True, ""


PAIRINGS = {
    "paired": ({}, LAT, None),
    "fewer object tokens": (dict(object_token_num=2), LAT, None),
    "more camera sites than given": (dict(camera_token_num=999), LAT, None),
    "default object tokens": (dict(object_token_num=16), LAT,
                              "object_token_num 16 > the AMD model's 4"),
    "wider object tokens": (dict(object_channel=64, motion_dim=64), LAT,
                            "object_channel 64 > the AMD model's "
                            "object_motion_token_channel 32"),
    "wider camera tokens": (dict(camera_channel=32), LAT,
                            "camera_channel 32 > the AMD model's "
                            "camera_motion_token_channel 16"),
    "reference grid": ({}, LAT // 2, "refimg_dim, refimg_height"),
}


@pytest.mark.parametrize("case", sorted(PAIRINGS))
def test_pairings_refused_where_jax_fails(stack, case):  # noqa: F811
    jstack, (_, amd, _) = stack
    over, latent, cause = PAIRINGS[case]
    trains, why = _jax_t2m_trains(jstack, over, latent)
    assert trains == (cause is None), why
    cfg = tt2m.T2MConfig(**dict(T2M_CFG, **over))
    if trains:
        train_t2m.check_pairing(cfg, amd.cfg, (4, latent, latent))
        return
    with pytest.raises(ValueError, match=cause.replace("(", r"\(")):
        train_t2m.check_pairing(cfg, amd.cfg, (4, latent, latent))


def test_frozen_model_refused_where_jax_refuses(files, monkeypatch):  # noqa: F811,E501
    """The JAX CLI refuses every frozen model its ``load_amd`` builds as
    ``AMDModel`` (all types but AMD_N, AMD_S_Camera too); the port refuses
    the same types, and a config without both streams."""
    from hivae_tpu.utils import misc as jmisc
    from hivae_tpu.training import checkpoint as jckpt
    monkeypatch.setattr(jmisc, "init_on_cpu", jax.eval_shape)
    monkeypatch.setattr(jckpt, "load_pretrain_partial",
                        lambda params, path: (params, {"missing": []}))
    with open(files / "config.json") as f:
        cfg = tamd.AMDConfig.from_dict(json.load(f))
    for model_type in ("AMD_N", "AMD_S", "AMD_L", "AMD_S_Camera"):
        args = _args(train_t2m, [])
        args.amd_config = str(files / "config.json")
        args.amd_ckpt = str(files / "amd.safetensors")
        args.model_type, args.video_frames = model_type, W
        jmodel, _ = jinfer.load_amd(args, jnp.float32)
        jax_trains = isinstance(jmodel, jamd.AMDModelNew)
        assert jax_trains == (model_type == "AMD_N")
        if jax_trains:
            train_t2m.check_frozen(model_type, cfg)
        else:
            with pytest.raises(ValueError, match=model_type):
                train_t2m.check_frozen(model_type, cfg)
    with pytest.raises(ValueError, match="needs both motion streams"):
        train_t2m.check_frozen("AMD_N", cfg.replace(use_object=False))


# -- the argument parsers --------------------------------------------------------


def _jax_args(monkeypatch, module, argv):
    monkeypatch.setattr(sys, "argv", [module.__file__] + argv)
    return module.parse_args()


PORT_ONLY = dict(device="cuda", resume_training=False, dist_backend=None)


@pytest.mark.parametrize("extra", [[], [
    "--mp", "no", "--ema_decay", "0.9", "--video_frames", "8",
    "--lr_warmup_steps", "3", "--t2m_config", "t.json", "--vae_ckpt", "v"]],
    ids=["defaults", "flags"])
def test_t2m_args_match_jax(monkeypatch, extra):
    argv = ["--amd_config", "c", "--amd_ckpt", "k", "--video_dir", "v"]
    want = _jax_args(monkeypatch, jtrain_t2m, argv + extra)
    assert vars(train_t2m.parse_args(argv + extra)) == dict(vars(want),
                                                             **PORT_ONLY)


@pytest.mark.parametrize("extra", [[], [
    "--mp", "no", "--model_type", "MAE_L", "--mask_ratio", "0.5",
    "--norm_pix_loss", "true", "--ema_decay", "0.99"]],
    ids=["defaults", "flags"])
def test_mae_args_match_jax(monkeypatch, extra):
    argv = ["--video_dir", "v"]
    want = _jax_args(monkeypatch, jtrain_mae, argv + extra)
    assert vars(train_mae.parse_args(argv + extra)) == dict(vars(want),
                                                             **PORT_ONLY)


# -- the MAE step -------------------------------------------------------------


def test_mae_step_matches_jax_train_step(stack, tmp_path):  # noqa: F811
    jstack, (vae, _, _) = stack
    encode = _jax_encode(jstack)[0]
    jmod = jmae.MaskedAutoencoderViT(norm_pix_loss=True, **MAE_TINY)
    params = random_params(jmod, jnp.zeros((1, 4, LAT, LAT)), seed=31)
    model = tmae.MaskedAutoencoderViT(norm_pix_loss=True, device="cpu",
                                      **MAE_TINY)
    model.load_state_dict(flax_to_torch(params), strict=True)
    rng = np.random.RandomState(32)
    videos = np.clip(rng.randn(4, 1, 3, SIZE, SIZE) * 0.5, -1, 1).astype(
        np.float32)
    noise = rng.randn(4, 4, LAT, LAT).astype(np.float32)
    mask = rng.rand(4, 16).astype(np.float32)
    z = encode(jnp.asarray(videos), noise)
    z = z.reshape((-1,) + z.shape[2:])

    def loss_fn(p):
        with _replay(uniform=[mask]):
            return jmod.apply(p, z, 0.75, rngs={"mask": KEY})[0]
    want, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    args = train_mae.parse_args(["--video_dir", "v", "--mp", "no",
                                 "--max_train_steps", "10"])
    trainer = train_mae.MAETrainer(model.train(), vae, args, str(tmp_path))
    m = trainer.train_step({"videos": videos, "name": ["a"] * 4},
                           train_mae.MAEDraws(_t(noise), _t(mask)))
    np.testing.assert_allclose(m["loss"].item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(),
                               float(optax.global_norm(grads)), rtol=1e-4)


# -- the CLIs end to end ------------------------------------------------------------


@pytest.fixture(scope="module")
def label_tree(tmp_path_factory):
    """Two class directories of two mp4s each."""
    d = tmp_path_factory.mktemp("t2m_tree")
    for i in range(4):
        cls = d / ("clsA", "clsB")[i % 2]
        cls.mkdir(exist_ok=True)
        _write_mp4(cls / f"v{i}.mp4", _frames(i, frames=12, size=SIZE))
    return d


def _train_argv(files, tree, tmp_path, extra=()):  # noqa: F811
    return ["--video_dir", str(tree), "--vae_ckpt",
            str(files / "vae.safetensors"), "--sample_size", str(SIZE), "--train_batch_size", "2",
            "--dataloader_num_workers", "2", "--mp", "no",
            "--save_checkpoint_interval_step", "1", "--output_dir",
            str(tmp_path), "--exp_name", "run", "--device", "cpu",
            "--seed", "3"] + list(extra)


def _check_run(module, argv, run, capsys):
    assert module.main(argv + ["--max_train_steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "grad_norm" in out
    assert sorted(os.listdir(run / "checkpoints")) == ["checkpoint-1",
                                                       "checkpoint-2"]
    assert module.main(argv + ["--max_train_steps", "3",
                               "--resume_training", "true"]) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    state = torch.load(str(run / "checkpoints" / "checkpoint-3" /
                           "state.pt"), weights_only=True)
    assert state["step"] == 3
    return state


def test_train_t2m_cli_end_to_end(files, fp32, label_tree, tmp_path,  # noqa: F811,E501
                                  capsys):
    cfg = tmp_path / "t2m.json"
    cfg.write_text(json.dumps(T2M_CFG))
    argv = _train_argv(files, label_tree, tmp_path, [
        "--t2m_config", str(cfg), "--video_frames", str(W),
        "--amd_config", str(files / "config.json"),
        "--amd_ckpt", str(files / "amd.safetensors")])
    state = _check_run(train_t2m, argv, tmp_path / "run", capsys)
    written = json.loads((tmp_path / "run" / "config.json").read_text())
    assert written == tt2m.T2MConfig.from_dict(
        dict(T2M_CFG, num_frames=W)).to_dict()
    assert "label_embedding" in state["params"]
    with pytest.raises(SystemExit, match="ZERO batches"):
        train_t2m.main(argv + ["--train_batch_size", "8"])
    # the refusals name their cause before anything is built
    cfg.write_text(json.dumps(dict(T2M_CFG, object_token_num=16)))
    with pytest.raises(ValueError, match="object_token_num 16"):
        train_t2m.main(argv)
    cfg.write_text(json.dumps(dict(T2M_CFG, num_classes=1)))
    with pytest.raises(ValueError, match="2 classes"):
        train_t2m.main(argv)
    cfg.write_text(json.dumps(T2M_CFG))
    with pytest.raises(ValueError, match="AMD_S: the head trains on"):
        train_t2m.main(argv + ["--model_type", "AMD_S"])


def test_train_mae_cli_end_to_end(files, fp32, label_tree, tmp_path,  # noqa: F811,E501
                                  capsys, monkeypatch):
    monkeypatch.setitem(tmae.MAE_MODELS, "MAE_TINY", lambda **kw: (
        tmae.MaskedAutoencoderViT(**MAE_TINY, **kw)))
    argv = _train_argv(files, label_tree, tmp_path, [
        "--model_type", "MAE_TINY", "--lr_warmup_steps", "1",
        "--ema_decay", "0.5"])
    state = _check_run(train_mae, argv, tmp_path / "run", capsys)
    assert state["ema_params"].keys() == state["params"].keys()
    with pytest.raises(ValueError, match="MAE_XL"):
        train_mae.main(argv + ["--model_type", "MAE_XL"])
    with pytest.raises(SystemExit, match="ZERO batches"):
        train_mae.main(argv + ["--train_batch_size", "8"])


def test_get_clip_emb_matches_jax(tmp_path, monkeypatch, capsys):
    caps = tmp_path / "caps.txt"
    caps.write_text("a person waves\n\nwalk\ta dog runs fast\nJUMP  high\n")
    for side, out in (("jax", tmp_path / "j"), ("port", tmp_path / "p")):
        argv = ["--captions", str(caps), "--output_dir", str(out),
                "--width", "24", "--save_sequence"]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["get_clip_emb.py"] + argv)
            jclip.main()
        else:
            assert get_clip_emb.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace(str(tmp_path / "j"), "") == \
        lines[1].replace(str(tmp_path / "p"), "")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "p")) == [
        "caption_00000.npy", "caption_00000_seq.npy", "caption_00003.npy",
        "caption_00003_seq.npy", "walk.npy", "walk_seq.npy"]
    for name in names:
        want = np.load(tmp_path / "j" / name)
        got = np.load(tmp_path / "p" / name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _stub_clip(monkeypatch, loads=True):
    """A stand-in ``transformers`` whose CLIP text model records the device
    of its token ids and returns (ids, width 6) as hidden states; loading
    a path fails unless ``loads``."""
    import types

    class Model(torch.nn.Module):
        config = types.SimpleNamespace(hidden_size=6)

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(6))
            self.seen = []

        def forward(self, input_ids):
            self.seen.append(input_ids.device)
            h = input_ids[..., None].float() * self.w
            return types.SimpleNamespace(last_hidden_state=h,
                                         pooler_output=h[:, 0])

    models = []

    def load_model(path):
        if not loads:
            raise OSError(f"no CLIP at {path}")
        models.append(Model())
        return models[-1]

    def load_tokenizer(path):
        def tok(texts, **kw):
            ids = torch.tensor([[len(t), 1, 2] for t in texts])
            return {"input_ids": ids}
        return tok
    stub = types.ModuleType("transformers")
    stub.CLIPTextModel = types.SimpleNamespace(from_pretrained=load_model)
    stub.CLIPTokenizer = types.SimpleNamespace(
        from_pretrained=load_tokenizer)
    monkeypatch.setitem(sys.modules, "transformers", stub)
    return models


def test_get_clip_emb_runs_clip_on_its_device(tmp_path, monkeypatch):
    """With ``--clip_path`` the CLIP model and its token ids are on
    ``--device``, and its outputs are what is written; a path that does
    not load raises, naming it, and writes nothing."""
    caps = tmp_path / "caps.txt"
    caps.write_text("a person waves\nrun\n")
    models = _stub_clip(monkeypatch)
    out = tmp_path / "out"
    assert get_clip_emb.main(["--captions", str(caps), "--output_dir",
                              str(out), "--clip_path", "clip",
                              "--device", "cpu"]) == 0
    (model,) = models
    assert model.w.device.type == "cpu" and \
        [d.type for d in model.seen] == ["cpu"]
    np.testing.assert_array_equal(np.load(out / "caption_00000.npy"),
                                  np.full(6, 14.0, np.float32))
    np.testing.assert_array_equal(np.load(out / "caption_00001.npy"),
                                  np.full(6, 3.0, np.float32))
    _stub_clip(monkeypatch, loads=False)
    with pytest.raises(RuntimeError, match="missing_clip"):
        get_clip_emb.main(["--captions", str(caps), "--output_dir",
                           str(tmp_path / "none"), "--clip_path",
                           "missing_clip", "--device", "cpu"])
    assert not list((tmp_path / "none").glob("*.npy"))
