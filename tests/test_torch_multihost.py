"""One training step of the port over a mesh of ranks against the JAX
trainer's step on the same mesh over fake devices, on the CPU, at the tiny
config: mesh (2, 1, 1) (data parallel) here, (1, 2, 1) (FSDP2 over gloo)
in ``test_torch_multihost_fsdp.py``, (1, 1, 2) with ring attention in
``test_torch_multihost_ring.py`` (one file each, so that they run on
separate workers), the CLI in ``test_torch_multihost_cli.py``.

The port runs in 2 processes over gloo (``run_ranks``, with a timeout a
process): each rank takes its rows of the global batch of 2 clips and
the global batch's draws (``StepDraws``), which the JAX step gets replayed
into ``jax.random`` (``test_torch_training._replay``). Held, as
``test_torch_training.py`` holds the one-card step: loss 1e-5 relative,
grad_norm 1e-4, each parameter's Adam move within 0.2% of lr where its
gradient stands clear of the frameworks' fp32 differences, and the move's
size elsewhere. The 2-rank step is also held to the port's own 1-rank step
on the same global batch (loss, grad_norm and gradients within 1e-6
relative: only the order of the reductions differs), and every rank ends
with the same parameters. Each mesh's checkpoint (the whole state,
gathered to rank 0) resumes on the same mesh bit for bit and on one rank
with the same parameters.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

from test_torch_ring import run_ranks

T, LAT, PIX, N = 4, 16, 32, 2
LR = 1e-3
TINY_VAE = dict(block_out_channels=(32, 64), layers_per_block=1,
                norm_num_groups=8)
RATIO = 0.5


def inputs(seed=0):
    """The global batch (N clips) and its draws, numpy."""
    rng = np.random.RandomState(seed)
    clips = [np.clip(rng.randn(T + 1, 3, PIX, PIX) * 0.5, -1, 1)
             .astype(np.float32) for _ in range(N)]
    sites = (LAT // 2) ** 2
    lat = (N * T, 4, LAT, LAT)
    return dict(
        clips=np.stack(clips),
        ts=rng.randint(0, 1001, (N,)).astype(np.int32),
        z0=rng.randn(*lat).astype(np.float32),
        cam_u=np.float32(rng.rand()), obj_u=np.float32(rng.rand()),
        cam_noise=rng.rand(N, sites).astype(np.float32),
        obj_noise=rng.rand(N * 2 * T, sites).astype(np.float32),
        posterior=np.stack([rng.randn(*lat).astype(np.float32)
                            for _ in range(4)]))


def _batch(x):
    from hivae_tpu_torch.training.trainer import batch_from_clips

    clips = list(x["clips"])
    grey = [np.repeat(c.mean(1, keepdims=True), 3, 1) for c in clips]
    return batch_from_clips(clips, grey)


def port_draws(x):
    import torch

    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.training import trainer as ttr

    perm = lambda a: torch.argsort(torch.from_numpy(a), dim=1, stable=True)
    keys = ("videos", "ref_img", "grey_videos", "ref_grey_img")
    return ttr.StepDraws(
        {k: torch.from_numpy(p) for k, p in zip(keys, x["posterior"])},
        tamd.TrainDraws(time_step=torch.from_numpy(np.repeat(x["ts"], T)),
                        z0=torch.from_numpy(x["z0"]),
                        camera_u=torch.tensor(float(x["cam_u"])),
                        object_u=torch.tensor(float(x["obj_u"])),
                        camera_perm=perm(x["cam_noise"]),
                        object_perm=perm(x["obj_noise"])))


def _trainer(workdir, mesh, out, resume=False):
    import torch

    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.models import vae as tvae
    from hivae_tpu_torch.training import trainer as ttr

    saved = torch.load(os.path.join(workdir, "model.pt"), weights_only=True)
    model = tamd.AMDModelNew(tamd.AMDConfig.from_dict(saved["cfg"]),
                             device="cpu")
    model.load_state_dict(saved["amd"], strict=True)
    vae = tvae.AutoencoderKL(tvae.VAEConfig(**TINY_VAE), device="cpu").eval()
    vae.load_state_dict(saved["vae"], strict=True)
    return ttr.AMDTrainer(model, vae, ttr.TrainConfig(
        output_dir=os.path.join(workdir, out), learning_rate=LR,
        mixed_precision="no", mu_dtype="bf16", camera_mask_ratio=RATIO,
        object_mask_ratio=RATIO, ema_decay=0.9, resume=resume), mesh=mesh)


def full(part, like):
    """The whole tensor of which ``part`` is this rank's part in ``like``'s
    layout, on every rank (all-gathered over each shard group)."""
    import torch

    from hivae_tpu_torch.parallel import comm

    mesh = getattr(like, "device_mesh", None)
    if mesh is None:
        return part
    out = part
    for m, pl in reversed(list(enumerate(like.placements))):
        if not pl.is_shard():
            continue
        d, n, size = pl.dim, mesh.size(m), like.shape[pl.dim]
        chunk = -(-size // n)
        pad = [0, 0] * (out.dim() - d - 1) + [0, chunk - out.shape[d]]
        out = comm.all_gather(torch.nn.functional.pad(out, pad),
                              mesh.get_group(m), d).narrow(d, 0, size)
    return out


def port_step(workdir, mesh, out="out"):
    """One port step on ``mesh`` from ``workdir``'s model, VAE and inputs
    (written by ``write_inputs``): this rank's rows -> (metrics, whole
    reduced gradients by name, whole parameters after the step). The
    trainer then saves ``<workdir>/<out>/checkpoints/checkpoint-1`` and a
    second trainer on the same mesh resumes from it, holding this rank's
    parameters, moments and EMA bit for bit."""
    import torch

    from hivae_tpu_torch.parallel.sharding import batch_rows, local

    trainer = _trainer(workdir, mesh, out)
    x = dict(np.load(os.path.join(workdir, "inputs.npz")))
    rows = batch_rows(trainer.mesh, N)
    batch = {k: v[rows] for k, v in _batch(x).items()}
    draws = port_draws(x)
    _, grads = trainer.loss_and_grads(trainer._to_device(batch), draws)
    names = list(trainer.state.params)
    grads = {n: full(local(g), g) for n, g in zip(names, grads)}
    metrics = trainer.train_step(batch, draws=draws)
    params = {n: full(local(p).detach(), p)
              for n, p in trainer.state.params.items()}
    saved = trainer.state.full_state_dict()
    if trainer.mesh.is_first:
        for n, p in params.items():
            assert torch.equal(saved["params"][n].to(p.device), p), n
    else:   # the whole state is gathered to rank 0 alone
        assert saved is None
    trainer.save()
    resumed = _trainer(workdir, mesh, out, resume=True)
    assert resumed.global_step == 1
    for a, b in ((trainer.state.state_dict(), resumed.state.state_dict()),):
        for name in a["params"]:
            assert torch.equal(a["params"][name], b["params"][name]), name
            assert torch.equal(a["ema_params"][name],
                               b["ema_params"][name]), name
        for key in ("mu", "nu"):
            for t, u in zip(a["opt_state"][key], b["opt_state"][key]):
                assert torch.equal(t, u), key
    return metrics, grads, params


def worker(rank, world, port, workdir, shape):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hivae_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = create_mesh(tuple(int(s) for s in shape.split(",")),
                       device_type="cpu")
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa

    out = port_step(workdir, mesh)
    torch.save(out + (dict(sequence_sharded_sdpa.calls),),
               os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


# -- the test side ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    return make_tiny()


def make_tiny():
    """The tiny JAX model and VAE with perturbed parameters, and the
    port's state dicts of them."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from hivae_tpu.models import vae as jvae
    from hivae_tpu_torch.utils.params import flax_to_torch
    from test_torch_training import _perturb

    key = jax.random.PRNGKey(0)
    jmod = graft._flagship(tiny=True, frames=T)
    v = jnp.zeros((1, T, 4, LAT, LAT))
    params = _perturb(jax.device_get(jax.jit(jmod.init)(
        {"params": key, "noise": key}, v, v, v, v)))
    jv = jvae.AutoencoderKL(cfg=jvae.VAEConfig(**TINY_VAE))
    vparams = _perturb(jax.device_get(jax.jit(jv.init)(
        key, jnp.zeros((1, 3, PIX, PIX)))), seed=5)
    return dict(jmod=jmod, params=params, jv=jv, vparams=vparams,
                amd=flax_to_torch(params), vae=flax_to_torch(vparams))


def write_inputs(tiny, workdir, attn_impl="auto"):
    import torch

    cfg = dict(tiny["jmod"].cfg.to_dict(), attn_impl=attn_impl)
    torch.save({"cfg": cfg, "amd": tiny["amd"], "vae": tiny["vae"]},
               os.path.join(workdir, "model.pt"))
    x = inputs()
    np.savez(os.path.join(workdir, "inputs.npz"), **x)
    return x


def jax_step(tiny, x, shape, workdir, attn_impl="auto"):
    """The JAX trainer's one step on ``shape`` over fake devices, its draws
    replayed -> (metrics, params after)."""
    import jax
    import jax.numpy as jnp

    from hivae_tpu.models import amd as jamd
    from hivae_tpu.training import trainer as jtr
    from test_torch_training import _replay

    jmod = jamd.AMDModelNew(cfg=dataclasses.replace(tiny["jmod"].cfg,
                                                    attn_impl=attn_impl))
    trainer = jtr.AMDTrainer(
        jmod, jax.tree.map(jnp.asarray, tiny["params"]), tiny["jv"],
        tiny["vparams"], jtr.TrainConfig(
            output_dir=os.path.join(workdir, "jax"), learning_rate=LR,
            mixed_precision="no",
            mu_dtype="bf16", mesh_shape=shape, camera_mask_ratio=RATIO,
            object_mask_ratio=RATIO, log_every=1, save_every=10 ** 9))
    queues = dict(normal=list(x["posterior"]) + [x["z0"]], randint=[x["ts"]],
                  uniform=[x["cam_u"], x["obj_u"], x["cam_noise"],
                           x["obj_noise"]])
    with _replay(**queues):
        metrics = trainer.fit(iter([_batch(x)]), max_steps=1)
    from hivae_tpu.ops import attention as jattn
    jattn.set_default_implementation("auto")
    jattn.set_ring_context(None)
    return metrics, jax.device_get(trainer.state.params)


def check_step_against_jax(tiny, metrics, grads, params, jmetrics,
                           jparams):
    """The tolerances of ``test_torch_training``'s whole-step test; which
    gradient entries stand clear of the frameworks' fp32 differences
    (above 1e-4 of the largest) is read on the port's gradients, which
    that file holds to the JAX package's within 1e-4."""
    from hivae_tpu_torch.utils.params import flax_to_torch

    np.testing.assert_allclose(metrics["loss"], jmetrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"], jmetrics["grad_norm"],
                               rtol=1e-4)
    before = tiny["amd"]
    after = flax_to_torch(jparams)
    g_max = max(g.abs().max().item() for g in grads.values())
    for name, p in params.items():
        moved_j = after[name].numpy() - before[name].numpy()
        moved_t = p.numpy() - before[name].numpy()
        err = np.abs(moved_t - moved_j)
        clear = np.abs(grads[name].numpy()) > 1e-4 * g_max
        assert err[clear].max(initial=0) <= 2e-3 * LR, name
        assert err.max() <= 2.1 * LR, name


def one_rank_step(workdir):
    from hivae_tpu_torch.parallel.mesh import local_mesh

    return port_step(workdir, local_mesh(), out="one")


def check_ranks(workdir, world, ref, rtol=1e-6):
    """Every rank's parameters equal; the step equals the 1-rank step up
    to the order of the reductions (``rtol``). Returns rank 0's (metrics,
    gradients, parameters, ring calls)."""
    import torch

    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=True) for r in range(world)]
    for r in ranks[1:]:
        for name, p in r[2].items():
            assert torch.equal(p, ranks[0][2][name]), name
    metrics, grads = ranks[0][:2]
    for k in ("loss", "grad_norm", "diff_loss", "rec_loss"):
        np.testing.assert_allclose(metrics[k], ref[0][k], rtol=rtol)
    g_max = max(g.abs().max().item() for g in ref[1].values())
    for name, g in grads.items():
        err = (g - ref[1][name]).abs().max().item()
        assert err <= rtol * g_max, (name, err, g_max)
    return ranks[0]


def check_checkpoint_on_one_rank(workdir, params):
    """The mesh's checkpoint holds the whole state, which a one-rank
    trainer resumes."""
    import torch

    from hivae_tpu_torch.parallel.mesh import local_mesh
    from hivae_tpu_torch.training import checkpoint as tckpt

    state = torch.load(os.path.join(workdir, "out", "checkpoints",
                                    "checkpoint-1", "state.pt"),
                       weights_only=True)
    for name, p in params.items():
        assert torch.equal(state["params"][name], p), name
    one = _trainer(workdir, local_mesh(), "out", resume=True)
    assert one.global_step == 1
    for name, p in one.state.params.items():
        assert torch.equal(p.detach(), params[name]), name
    assert tckpt.load_trained_params(os.path.join(workdir, "out",
                                                  "checkpoints")).keys() \
        == params.keys()


def check_mesh_step(tiny, shape, tmp_path):
    """A 2-rank step on ``shape`` against the port's 1-rank step, the JAX
    trainer's step on the same mesh, and its checkpoint on one rank."""
    x = write_inputs(tiny, str(tmp_path))
    run_ranks(os.path.abspath(__file__), 2,
              [tmp_path, ",".join(map(str, shape))])
    ref = one_rank_step(str(tmp_path))
    metrics, grads, params, calls = check_ranks(str(tmp_path), 2, ref)
    assert calls == {"kernel": 0, "plain": 0}
    check_checkpoint_on_one_rank(str(tmp_path), params)
    jmetrics, jparams = jax_step(tiny, x, shape, str(tmp_path))
    check_step_against_jax(tiny, metrics, grads, params, jmetrics, jparams)


def test_data_parallel_step_matches_jax_trainer(tiny, tmp_path):
    check_mesh_step(tiny, (2, 1, 1), tmp_path)


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(*map(int, sys.argv[2:5]), *sys.argv[5:])
