"""A2M training with the port (``data/datasets.py``'s audio datasets and
``cli/train_a2m.py``) against the JAX package, fp32 on the CPU, on the
tiny stack of ``test_torch_a2v`` (the tiny flagship AMD_N, a tiny SD-VAE
and tiny A2M heads whose tokens are AMD_N's object tokens):

  * ``VideoAudioDataset`` and ``VideoAudioRandomRefDataset`` bit for bit
    against the JAX datasets under the same seed: every key of every
    sample, over repeated draws, with and without a ``pose_path`` stream,
    including a clip shorter than the window (zero-padded, masked);
  * ``A2MTrainer``'s step against the JAX CLI's ``train_step``, composed
    from the package's functions as ``train_a2m.py`` composes it, the five
    draws (the clip's, the reference's, the pose stream's and the
    reference pose's posterior noise, then the head's timestep and flow
    noise) drawn with numpy and replayed into both: the audio head with
    and without a pose stream and the LearnableToken head; loss, metrics,
    ``grad_norm``, the parameters after AdamW and their EMA, at
    ``test_torch_training``'s tolerances;
  * which of the JAX trainer's six head types train: each is held to the
    JAX CLI's own initialisation and step (``jax.eval_shape``), with and
    without a pose stream; the port refuses, with a ``ValueError``
    naming the cause, exactly where the JAX CLI fails;
  * the argument parser against ``train_a2m.py``'s (the port adds
    ``--device``, ``--resume_training`` and ``--dist_backend``);
  * the CLI end to end on mp4s, embeddings and a ``.pkl`` index: the
    LearnableToken head 2 steps with a checkpoint each step, a resume to
    step 3, then ``cli.a2v_inference`` serving the checkpoint it wrote;
    and the ``SystemExit`` of a dataset that yields no batch."""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_a2m as jtrain
from hivae_tpu.data import datasets as jdata
from hivae_tpu.models import a2m as ja2m
from hivae_tpu.models import vae as jvae
from hivae_tpu.training import train_state as jts
from hivae_tpu_torch.cli import a2v_inference, train_a2m
from hivae_tpu_torch.data import datasets as tdata
from hivae_tpu_torch.utils.params import flax_to_torch
from test_torch_a2v import A2M_CFG, C, M, SIZE, W, stack  # noqa: F401
from test_torch_a2v_cli import _argv, files, fp32  # noqa: F401
from test_torch_amd_family import _one_thread  # noqa: F401
from test_torch_amd_family_models import random_params
from test_torch_data import _frames, _write_mp4
from test_torch_training import _replay

N = 2
LAT = SIZE // 2
KEY = jax.random.PRNGKey(0)
TYPES = ("A2MModel_CrossAtten_Audio", "A2MModel_CrossAtten_Audio_Pose",
         "A2MModel_CrossAtten_Pose", "A2MModel_LearnableToken",
         "A2MModel_SimpleAdaLN", "A2MModel_CrossAtten_Audio_PosePre")


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- the datasets --------------------------------------------------------------


@pytest.fixture(scope="module")
def av_index(tmp_path_factory):
    """Two .pkl indexes of mp4s with embeddings: one with a pose stream
    for every entry, one without; the last clip (3 frames, embeddings of
    5) is shorter than a window of W + 1."""
    d = tmp_path_factory.mktemp("av_index")
    entries = []
    for i, (frames, emb) in enumerate(((12, 12), (9, 14), (3, 5))):
        video, pose = d / f"v{i}.mp4", d / f"p{i}.mp4"
        _write_mp4(video, _frames(i, frames=frames, size=24))
        _write_mp4(pose, _frames(i + 10, frames=frames, size=24))
        np.save(d / f"v{i}.npy", _rand(emb, M, C, seed=i))
        entries.append({"video_path": str(video),
                        "audio_emb_path": str(d / f"v{i}.npy"),
                        "pose_path": str(pose)})
    paths = {}
    for name, rows in (("pose", entries), ("plain", [
            {k: v for k, v in e.items() if k != "pose_path"}
            for e in entries])):
        paths[name] = str(d / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(rows, f)
    return paths


@pytest.mark.parametrize("pose", [False, True], ids=["plain", "pose"])
@pytest.mark.parametrize("name", ["VideoAudioDataset",
                                  "VideoAudioRandomRefDataset"])
def test_audio_datasets_bit_equal(av_index, name, pose):
    index = av_index["pose" if pose else "plain"]
    kw = dict(sample_n_frames=W, sample_size=SIZE, seed=3)
    jds = getattr(jdata, name)(index, **kw)
    tds = getattr(tdata, name)(index, **kw)
    for _ in range(3):
        for i in range(len(jds)):
            want, got = jds[i], tds[i]
            assert got.keys() == want.keys()
            assert ("gt_pose" in got) == pose
            for k in got:
                if k == "name":
                    assert got[k] == want[k]
                    continue
                assert got[k].dtype == want[k].dtype, k
                assert np.array_equal(got[k], want[k]), (name, i, k)
    short = tds[2]
    # 3 usable frames: the frame before the clip and 2, or 3 and one of them
    # again as the reference
    assert short["mask"].sum() == (2 if name == "VideoAudioDataset" else 3)


# -- the step ------------------------------------------------------------------

CASES = {"audio": ("A2MModel_CrossAtten_Audio", False),
         "audio_pose_stream": ("A2MModel_CrossAtten_Audio", True),
         "learnable_token": ("A2MModel_LearnableToken", False)}


def _heads(jstack, model_type):
    """(JAX head, its params, the port's head on them, fp32, trainable)."""
    if model_type == "A2MModel_CrossAtten_Audio":
        jmod, params = jstack[4], jstack[5]
    else:
        jmod = ja2m.A2MModelLearnableToken(cfg=ja2m.A2MConfig(**A2M_CFG))
        motion, audio = jnp.zeros((1, W, 4, 32)), jnp.zeros((1, W, M, C))
        params = random_params(jmod, motion, motion[:, 0], audio=audio,
                               ref_audio=audio[:, 0], seed=8)
    tmod = a2v_inference.build_a2m(
        {"model_type": model_type, "model": A2M_CFG}, "cpu")
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    return jmod, params, tmod.train()


def _batch(seed, pose):
    rng = np.random.RandomState(seed)
    clip = np.clip(rng.randn(N, W + 1, 3, SIZE, SIZE) * 0.5, -1, 1)
    batch = {"gt_video": clip[:, 1:], "ref_video": np.repeat(
        clip[:, :1], W, axis=1),
        "gt_audio": rng.randn(N, W, M, C), "ref_audio": rng.randn(N, M, C),
        "mask": np.array([[1, 1, 1, 0], [1, 1, 0, 0]])}
    if pose:
        poses = np.clip(rng.randn(N, W + 1, 3, SIZE, SIZE) * 0.5, -1, 1)
        batch.update(ref_pose=poses[:, 0], gt_pose=poses[:, 1:])
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _draws(seed, pose):
    """The step's draws in the JAX step's order (numpy)."""
    rng = np.random.RandomState(seed)
    out = {"video": rng.randn(N * W, 4, LAT, LAT),
           "ref": rng.randn(N, 4, LAT, LAT)}
    extra = rng.randn(N * W + N, 4, LAT, LAT)
    if pose:
        out.update(pose=extra[:N * W], ref_pose=extra[N * W:])
    out.update(timestep=np.array([250, 871]), z0=rng.randn(N, W, 4, 32))
    return {k: v.astype(np.int32 if k == "timestep" else np.float32)
            for k, v in out.items()}


_FROZEN = {}


def _frozen_fns(jstack):
    """The JAX side's jitted posterior-sample encode (its noise an
    argument, replayed into ``jax.random.normal``) and motion extraction,
    compiled once for the cases of a module."""
    jvae_mod, vparams, jamd_mod, amd_params = jstack[:4]
    if id(vparams) not in _FROZEN:
        @jax.jit
        def encode(x, noise):
            with _replay(normal=[noise]):
                return jvae.vae_encode(jvae_mod, vparams, x, KEY)

        motion = jax.jit(lambda z: jamd_mod.apply(amd_params, z,
                                                  method="extract_motion"))
        _FROZEN[id(vparams)] = encode, motion
    return _FROZEN[id(vparams)]


def _jax_step(jstack, jmod, params, batch, d, lr, ema):
    """``train_a2m.py``'s ``train_step`` (its five keys replaced by the
    replayed draws) -> (new state, metrics, grads)."""
    encode, motion = _frozen_fns(jstack)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    motion_gt = motion(encode(b["gt_video"], d["video"]))
    ref_motion = motion(encode(b["ref_video"][:, :1], d["ref"]))[:, 0]
    pose_kw = {}
    if "gt_pose" in b:
        pose_kw = dict(pose=encode(b["gt_pose"], d["pose"]),
                       ref_pose=encode(b["ref_pose"][:, None],
                                       d["ref_pose"])[:, 0])

    def loss_fn(p):
        with _replay(randint=[d["timestep"]], normal=[d["z0"]]):
            ld = jmod.apply(p, motion_gt, ref_motion, audio=b["gt_audio"],
                            ref_audio=b["ref_audio"], mask=b["mask"],
                            rngs={"noise": KEY}, **pose_kw)
        return ld["loss"], ld

    (_, ld), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    state = jts.TrainState.create(params, jts.make_optimizer(lr, 0, 10),
                                  ema_decay=ema)
    state = jax.jit(lambda st, g: st.apply_gradients(g))(state, grads)
    metrics = dict(ld, grad_norm=optax.global_norm(grads))
    return state, metrics, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax_train_step(stack, case, tmp_path):  # noqa: F811
    jstack, (vae, amd, _) = stack
    model_type, pose = CASES[case]
    jmod, params, head = _heads(jstack, model_type)
    batch, d = _batch(11, pose), _draws(12, pose)
    lr, ema = 1e-3, 0.5
    state, jm, grads = _jax_step(jstack, jmod, params, batch, d, lr, ema)

    args = train_a2m.parse_args([
        "--a2m_config", "a", "--amd_config", "c", "--amd_ckpt", "k",
        "--video_dir", "v", "--mp", "no", "--learning_rate", str(lr),
        "--ema_decay", str(ema), "--max_train_steps", "10"])
    trainer = train_a2m.A2MTrainer(head, amd, vae, args, str(tmp_path))
    m = trainer.train_step(batch, train_a2m.A2MDraws(
        **{k: torch.from_numpy(v).long() if k == "timestep"
           else torch.from_numpy(v) for k, v in d.items()}))
    assert m.keys() == jm.keys()
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                               rtol=1e-4)
    before = flax_to_torch(params)
    after = flax_to_torch(jax.device_get(state.params))
    ema_after = flax_to_torch(jax.device_get(state.ema_params))
    jgrads = flax_to_torch(jax.device_get(grads))
    g_max = max(g.abs().max().item() for g in jgrads.values())
    for name, p in head.named_parameters():
        moved_j = after[name].numpy() - before[name].numpy()
        moved_t = p.detach().numpy() - before[name].numpy()
        err = np.abs(moved_t - moved_j)
        # as test_torch_training: where the gradient stands clear of the
        # two sides' fp32 differences the moves agree closely; below,
        # Adam's g / (|g| + eps) amplifies them
        clear = np.abs(jgrads[name].numpy()) > 1e-4 * g_max
        assert err[clear].max(initial=0) <= 2e-3 * lr, name
        assert err.max() <= 2.1 * lr, name
        e_err = np.abs(trainer.state.ema_params[name].numpy()
                       - ema_after[name].numpy())
        assert e_err.max() <= 2.1 * lr * (1 - ema), name


# -- which heads train ---------------------------------------------------------


def _jax_trains(model_type, pose):
    """True where the JAX CLI's initialisation (``train_a2m.py``, audio
    inputs only) and its step's loss (pose kwargs with a pose stream) both
    trace; ``jax.eval_shape``, nothing runs."""
    tiny = dict(A2M_CFG, pose_height=LAT, pose_width=LAT,
                pose_predictor_attn_head_dim=8,
                pose_predictor_attn_num_heads=2,
                pose_predictor_attn_num_layers=1)
    model, cfg = jtrain.build_a2m({"model_type": model_type,
                                   "model": tiny}, jnp.float32)
    motion = jnp.zeros((1, W, cfg.motion_num_token, cfg.motion_in_channel))
    audio = jnp.zeros((1, W, cfg.audio_block, cfg.audio_inchannel))
    try:
        params = jax.eval_shape(lambda: model.init(
            {"params": KEY, "noise": KEY}, motion, motion[:, 0], audio=audio,
            ref_audio=audio[:, 0]))
        kw = {}
        if pose:
            p = jnp.zeros((1, W, 4, LAT, LAT))
            kw = dict(pose=p, ref_pose=p[:, 0])
        jax.eval_shape(lambda prm: model.apply(
            prm, motion, motion[:, 0], audio=audio, ref_audio=audio[:, 0],
            mask=jnp.ones((1, W)), rngs={"noise": KEY}, **kw), params)
    except (TypeError, AttributeError):
        return False
    return True


@pytest.mark.parametrize("pose", [False, True], ids=["plain", "pose"])
@pytest.mark.parametrize("model_type", TYPES)
def test_trainable_types_match_jax(av_index, model_type, pose):
    """The audio head trains with or without a pose stream, LearnableToken
    and SimpleAdaLN without one; the heads that condition on pose never
    (the JAX initialisation passes none). The port refuses the others up
    front, naming the cause."""
    dataset = tdata.VideoAudioDataset(av_index["pose" if pose else "plain"])
    spec = {"model_type": model_type, "model": A2M_CFG}
    trains = _jax_trains(model_type, pose)
    assert trains == (model_type == "A2MModel_CrossAtten_Audio" or (
        model_type in train_a2m.NO_POSE_KWARG and not pose))
    if trains:
        train_a2m.check_trainable(spec, dataset)
        return
    cause = "takes no pose input" if model_type in train_a2m.NO_POSE_KWARG \
        else "conditions on pose"
    with pytest.raises(ValueError, match=cause):
        train_a2m.check_trainable(spec, dataset)


REQUIRED = ["--a2m_config", "a.yaml", "--amd_config", "c.json",
            "--amd_ckpt", "k", "--video_dir", "i.pkl"]


@pytest.mark.parametrize("extra", [[], [
    "--mp", "no", "--dataset", "A2MVideoAudioPoseRandomRef", "--ema_decay",
    "0.9", "--video_frames", "8", "--lr_warmup_steps", "3", "--vae_ckpt",
    "v.safetensors", "--checkpoint_total_limit", "5"]],
    ids=["defaults", "flags"])
def test_cli_args_match_jax(monkeypatch, extra):
    monkeypatch.setattr(sys, "argv", ["train_a2m.py"] + REQUIRED + extra)
    want = jtrain.parse_args()
    got = train_a2m.parse_args(REQUIRED + extra)
    assert vars(got) == dict(vars(want), device="cuda",
                             resume_training=False, dist_backend=None)


# -- the CLI end to end --------------------------------------------------------


def test_cli_trains_resumes_and_serves(  # noqa: F811
        files, fp32, av_index, tmp_path, capsys):
    """The LearnableToken head on the plain index (tiny SD-VAE; fp32), 2
    steps, resumed to 3, then served by ``cli.a2v_inference``."""
    spec = tmp_path / "learnable.json"
    spec.write_text(__import__("json").dumps(
        {"model_type": "A2MModel_LearnableToken", "model": A2M_CFG}))
    argv = ["--a2m_config", str(spec), "--amd_config",
            str(files / "config.json"), "--amd_ckpt",
            str(files / "amd.safetensors"), "--vae_ckpt",
            str(files / "vae.safetensors"), "--video_dir", av_index["plain"],
            "--video_frames", str(W), "--sample_size", str(SIZE),
            "--train_batch_size", "2", "--dataloader_num_workers", "2",
            "--save_checkpoint_interval_step", "1", "--output_dir",
            str(tmp_path), "--exp_name", "run", "--device", "cpu"]
    assert train_a2m.main(argv + ["--max_train_steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "final metrics:" in out and "grad_norm" in out
    run = tmp_path / "run"
    assert sorted(os.listdir(run / "checkpoints")) == ["checkpoint-1",
                                                       "checkpoint-2"]
    assert a2v_inference.load_spec(str(run / "config.json"))[
        "model_type"] == "A2MModel_LearnableToken"
    assert train_a2m.main(argv + ["--max_train_steps", "3",
                                  "--resume_training", "true"]) == 0
    assert "resumed at step 2" in capsys.readouterr().out
    state = torch.load(str(run / "checkpoints" / "checkpoint-3" / "state.pt"),
                       weights_only=True)
    assert state["step"] == 3

    serve = _argv(files, tmp_path / "talk.mp4")
    for flag, value in (("--a2m_config", str(run / "config.json")),
                        ("--a2m_ckpt", str(run / "checkpoints"))):
        serve[serve.index(flag) + 1] = value
    assert a2v_inference.main(serve + ["--device", "cpu"]) == 0
    assert "generated" in capsys.readouterr().out

    with pytest.raises(SystemExit, match="ZERO batches"):
        train_a2m.main(argv + ["--train_batch_size", "4"])
