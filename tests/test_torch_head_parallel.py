"""The head trainers (``cli/common.py::HeadTrainer``: ``train_a2m``,
``train_t2m``, ``train_mae``) data parallel over 2 gloo processes, mesh
(2, 1, 1), on the CPU at tiny configs in fp32, against their one-rank
steps on the same global batch.

One spawn (``run_ranks``) runs the three trainers in turn. Each rank takes
its rows of the global batch and draws the global batch's noise from the
step's generator (no draws passed in); held against the one-rank step:
loss within 1e-6 relative (the A2M batch's frame masks differ between the
ranks' rows, so its masked mean needs each rank's share), ``grad_norm``
and every gradient within 1e-6 of the largest, and both ranks'
parameters equal after the update. Rank 0 alone writes the checkpoint,
which resumes on one rank with the same parameters; the one-rank
checkpoint resumes on both ranks. The loader's shards are disjoint and
their union is the one-rank loader's batch, step by step; a global batch
the ranks do not divide is refused.

The one-rank steps are held to the JAX CLIs' steps in
``test_torch_a2m_train.py`` and ``test_torch_t2m_mae_cli.py``; no JAX
step is compiled here.
"""

import os
import sys

import numpy as np
import pytest

from test_torch_ring import run_ranks

KINDS = ("a2m", "t2m", "mae")
N, W, SIZE, LAT = 4, 4, 32, 16
M, C = 3, 8
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1,
                norm_num_groups=8)
A2M_SPEC = {"model_type": "A2MModel_CrossAtten_Audio", "model": dict(
    audio_inchannel=C, audio_block=M, motion_num_token=4,
    motion_in_channel=32, motion_frames=W, window_size=2,
    encoder_out_dim=16, intermediate_dim=24, diffusion_attn_head_dim=16,
    diffusion_attn_num_heads=2, diffusion_num_layers=2)}
T2M_CFG = dict(label_dim=16, num_classes=3, motion_dim=16, refimg_width=LAT,
               refimg_height=LAT, refimg_patch_size=2, refimg_dim=4,
               time_embed_dim=32, attention_head_dim=8, num_attention_heads=2,
               num_layers=1, camera_token_num=4, camera_channel=8,
               object_token_num=4, object_channel=16)
MAE_TINY = dict(img_size=(LAT, LAT), patch_size=4, embed_dim=32, depth=1,
                num_heads=2, decoder_embed_dim=16, decoder_depth=1,
                decoder_num_heads=2)
RTOL = 1e-6


def _amd_cfg():
    import __graft_entry__ as graft

    return graft._flagship(tiny=True, frames=W).cfg.to_dict()


def write_models(workdir):
    """The frozen tiny AMD model and VAE and the three trained modules
    (torch's initialisation, perturbed), and each trainer's global batch,
    in ``workdir``."""
    import torch

    from hivae_tpu_torch.cli.a2v_inference import build_a2m
    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.models import mae as tmae
    from hivae_tpu_torch.models import t2m as tt2m
    from hivae_tpu_torch.models import vae as tvae

    torch.manual_seed(0)
    cfg = _amd_cfg()
    mods = {"amd": tamd.AMDModelNew(tamd.AMDConfig.from_dict(cfg),
                                    device="cpu"),
            "vae": tvae.AutoencoderKL(tvae.VAEConfig(**TINY_VAE),
                                      device="cpu"),
            "a2m": build_a2m(A2M_SPEC, "cpu"),
            "t2m": tt2m.Label2MotionDiffusionDecoder(
                tt2m.T2MConfig(**T2M_CFG), device="cpu"),
            "mae": tmae.MaskedAutoencoderViT(norm_pix_loss=True,
                                             device="cpu", **MAE_TINY)}
    with torch.no_grad():
        for m in mods.values():
            for p in m.parameters():
                p.add_(0.02 * torch.randn_like(p))
    torch.save({"cfg": cfg, **{k: m.state_dict() for k, m in mods.items()}},
               os.path.join(workdir, "models.pt"))
    rng = np.random.RandomState(5)

    def pix(*lead):
        return np.clip(rng.randn(*lead, 3, SIZE, SIZE) * 0.5, -1, 1)

    clip, grey = pix(N, W + 1), pix(N, W)
    batches = {
        # rank 0's two clips keep 3 + 4 frames, rank 1's 2 + 1
        "a2m": {"gt_video": clip[:, 1:],
                "ref_video": np.repeat(clip[:, :1], W, axis=1),
                "gt_audio": rng.randn(N, W, M, C),
                "ref_audio": rng.randn(N, M, C),
                "mask": np.array([[1, 1, 1, 0], [1, 1, 1, 1],
                                  [1, 1, 0, 0], [1, 0, 0, 0]])},
        "t2m": {"videos": clip[:, 1:],
                "ref_img": np.repeat(clip[:, :1], W, axis=1),
                "grey_videos": grey,
                "ref_grey_img": np.repeat(grey[:, :1], W, axis=1),
                "label": np.array([2, 0, 1, 1])},
        "mae": {"videos": clip[:, :1]}}
    np.savez(os.path.join(workdir, "batches.npz"), **{
        f"{k}.{n}": v.astype(np.int64 if n == "label" else np.float32)
        for k, b in batches.items() for n, v in b.items()})


def _batch(workdir, kind):
    with np.load(os.path.join(workdir, "batches.npz")) as z:
        return {n.split(".", 1)[1]: z[n] for n in z.files
                if n.startswith(kind + ".")}


def trainer(workdir, kind, out, resume=False):
    """The ``kind`` trainer on this process's mesh (every rank on data),
    its modules from ``workdir``, checkpoints under ``<workdir>/<out>``."""
    import torch

    from hivae_tpu_torch.cli import a2v_inference, train_a2m, train_mae
    from hivae_tpu_torch.cli import train_t2m
    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.models import mae as tmae
    from hivae_tpu_torch.models import t2m as tt2m
    from hivae_tpu_torch.models import vae as tvae

    saved = torch.load(os.path.join(workdir, "models.pt"), weights_only=True)
    vae = tvae.AutoencoderKL(tvae.VAEConfig(**TINY_VAE), device="cpu")
    vae.load_state_dict(saved["vae"])
    vae.eval().requires_grad_(False)
    base = ["--mp", "no", "--learning_rate", "1e-3", "--ema_decay", "0.5",
            "--max_train_steps", "10"]
    frozen = ["--amd_config", "c", "--amd_ckpt", "k", "--video_dir", "v"]
    out = os.path.join(workdir, out)
    if kind == "mae":
        model = tmae.MaskedAutoencoderViT(norm_pix_loss=True, device="cpu",
                                          **MAE_TINY)
        model.load_state_dict(saved["mae"])
        args = train_mae.parse_args(["--video_dir", "v"] + base)
        return train_mae.MAETrainer(model.train(), vae, args, out)
    amd = tamd.AMDModelNew(tamd.AMDConfig.from_dict(saved["cfg"]),
                           device="cpu")
    amd.load_state_dict(saved["amd"])
    amd.eval().requires_grad_(False)
    if kind == "a2m":
        head = a2v_inference.build_a2m(A2M_SPEC, "cpu")
        head.load_state_dict(saved["a2m"])
        args = train_a2m.parse_args(["--a2m_config", "a"] + frozen + base)
        return train_a2m.A2MTrainer(head.train(), amd, vae, args, out)
    head = tt2m.Label2MotionDiffusionDecoder(tt2m.T2MConfig(**T2M_CFG),
                                             device="cpu")
    head.load_state_dict(saved["t2m"])
    args = train_t2m.parse_args(frozen + base)
    return train_t2m.T2MTrainer(head.train(), amd, vae, args, out)


def step(workdir, kind, out):
    """One step of this rank's rows -> (metrics, averaged gradients by
    name, parameters after the update); the trainer then saves."""
    from hivae_tpu_torch.parallel.sharding import batch_rows

    tr = trainer(workdir, kind, out)
    rows = batch_rows(tr.mesh, N)
    batch = {k: v[rows] for k, v in _batch(workdir, kind).items()}
    _, grads = tr.loss_and_grads(tr._to_device(batch))
    grads = dict(zip(tr.state.params, grads))
    metrics = {k: float(v) for k, v in tr.train_step(batch).items()}
    params = {k: p.detach().clone() for k, p in tr.state.params.items()}
    path = tr.save()
    assert (path is not None) == tr.mesh.is_first, path
    return metrics, grads, params


class _Items:
    """A dataset of its indices."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"i": np.int64(i)}


def loader_batches(mesh, batch_size=4):
    """The indices of each of this rank's batches over one epoch."""
    import types

    from hivae_tpu_torch.cli import common

    args = types.SimpleNamespace(train_batch_size=batch_size,
                                 dataloader_num_workers=1)
    return [b["i"].tolist()
            for b in common.training_loader(_Items(), args, mesh)]


def worker(rank, world, port, workdir):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hivae_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    got = {kind: step(workdir, kind, f"ranks_{kind}") for kind in KINDS}
    for kind in KINDS:   # the one-rank checkpoint on both ranks
        tr = trainer(workdir, kind, f"one_{kind}")
        tr.restore()
        one = torch.load(os.path.join(
            workdir, f"one_{kind}", "checkpoints", "checkpoint-1",
            "state.pt"), weights_only=True)
        assert tr.state.step == 1, kind
        for name, p in tr.state.params.items():
            assert torch.equal(p.detach(), one["params"][name]), name
    mesh = create_mesh(device_type="cpu")
    assert mesh.shape == {"data": 2, "fsdp": 1, "tensor": 1}
    got["loader"] = loader_batches(mesh)
    with pytest.raises(ValueError, match="must be divisible by the "
                       "data-parallel extent 2"):
        loader_batches(mesh, 3)
    torch.save(got, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test side ------------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The one-rank steps (their checkpoints written first), then the
    2-rank spawn -> (workdir, one-rank results, each rank's)."""
    import torch

    work = str(tmp_path_factory.mktemp("heads"))
    write_models(work)
    one = {kind: step(work, kind, f"one_{kind}") for kind in KINDS}
    run_ranks(os.path.abspath(__file__), 2, [work])
    got = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
           for r in range(2)]
    return work, one, got


@pytest.mark.parametrize("kind", KINDS)
def test_two_rank_step_matches_one_rank(ranks, kind):
    import torch

    _, one, got = ranks
    metrics, grads, params = one[kind]
    for r in got:
        m, g, p = r[kind]
        assert m.keys() == metrics.keys()
        for k in metrics:
            np.testing.assert_allclose(m[k], metrics[k], rtol=RTOL,
                                       err_msg=k)
        g_max = max(x.abs().max().item() for x in grads.values())
        for name, x in grads.items():
            err = (g[name] - x).abs().max().item()
            assert err <= RTOL * g_max, (name, err, g_max)
        for name in params:
            assert torch.equal(p[name], got[0][kind][2][name]), name


@pytest.mark.parametrize("kind", KINDS)
def test_rank_zero_checkpoint_resumes_on_one_rank(ranks, kind):
    import torch

    work, _, got = ranks
    ckpts = os.path.join(work, f"ranks_{kind}", "checkpoints")
    assert os.listdir(ckpts) == ["checkpoint-1"]
    tr = trainer(work, kind, f"ranks_{kind}")
    tr.restore()
    assert tr.state.step == 1
    for name, p in tr.state.params.items():
        assert torch.equal(p.detach(), got[0][kind][2][name]), name


def test_loader_shards_are_disjoint_and_cover_a_batch(ranks):
    from hivae_tpu_torch.parallel.mesh import local_mesh

    _, _, got = ranks
    one = loader_batches(local_mesh())
    shards = [r["loader"] for r in got]
    assert len(shards[0]) == len(shards[1]) == len(one) == 2
    for s, want in enumerate(one):
        a, b = shards[0][s], shards[1][s]
        assert len(a) == len(b) == 2 and not set(a) & set(b)
        assert sorted(a + b) == sorted(want)


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(*map(int, sys.argv[2:5]), *sys.argv[5:])
