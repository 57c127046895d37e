"""Weight tensor parallelism over the mesh's ``tensor`` axis
(``hivae_tpu_torch/parallel/tensor_parallel.py``) on the CPU.

  * The plan against the JAX rule: on ``meta``, AMD_N at full width and a
    ``tensor`` extent of 2, the weights the port splits are the ones the
    JAX ``infer_param_sharding`` shards on ``tensor`` over a
    ``jax.eval_shape`` tree (the same weights, on the same dims moved
    through the layouts; no block is kept replicated there).
  * One spawn of 2 gloo processes (``run_ranks``) at the tiny config in
    fp32: the (1, 1, 2) step without remat and with the ``full`` and
    ``dots`` policies against the port's one-rank step (without remat,
    the one reference of every mesh step here) on the same global batch
    and draws (loss, ``grad_norm`` and every gradient within 1e-6
    relative: only the order of the sums differs), every rank's
    parameters equal after it; the checkpoint it writes resumes on
    (1, 1, 2) bit for bit and on one rank with the same parameters
    (``test_torch_multihost.port_step``); the column and row parallel
    ``Attention`` (self and cross, with the per-head q/k norm),
    ``FeedForward`` and ``Mlp`` against the whole modules (outputs, input
    gradients and every parameter's gradient).
  * One spawn of 4 processes: FSDP2 with tensor parallelism, (1, 2, 2),
    and data parallelism with tensor parallelism, (2, 1, 2) (the
    gradients' local parts averaged over each tensor index's data group),
    each against the one-rank step as above, its checkpoint on one
    rank.
  * ``cli.train_amd --mesh 1,1,2`` on 2 processes, its checkpoint served
    by ``cli.amd_inference`` in one.

The one-rank steps are held to the JAX trainer's in
``test_torch_training.py`` and ``test_torch_multihost.py``; no JAX step is
compiled here.
"""

import copy
import os
import shutil
import sys

import numpy as np
import pytest

import test_torch_multihost as mh
from test_torch_ring import run_ranks

REMATS = {"none": dict(remat=False), "full": dict(remat=True),
          "dots": dict(remat=True, remat_policy="dots")}
MODULE_RTOL = 1e-6
# the meshes of the 4-process spawn, in the order it builds them
MESHES_4 = ("1,2,2", "2,1,2")


def _tiny_cfg():
    import __graft_entry__ as graft

    return graft._flagship(tiny=True, frames=mh.T).cfg.to_dict()


def write_tiny(workdir, **over):
    """The tiny model (torch's initialisation, every parameter perturbed so
    that no gradient is zero by construction), a tiny VAE and the inputs,
    in ``workdir`` as ``test_torch_multihost.write_inputs`` writes them."""
    import torch

    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.models import vae as tvae

    os.makedirs(workdir, exist_ok=True)
    cfg = dict(_tiny_cfg(), **over)
    torch.manual_seed(0)
    model = tamd.AMDModelNew(tamd.AMDConfig.from_dict(cfg), device="cpu")
    vae = tvae.AutoencoderKL(tvae.VAEConfig(**mh.TINY_VAE), device="cpu")
    with torch.no_grad():
        for p in list(model.parameters()) + list(vae.parameters()):
            p.add_(0.02 * torch.randn_like(p))
    torch.save({"cfg": cfg, "amd": model.state_dict(),
                "vae": vae.state_dict()},
               os.path.join(workdir, "model.pt"))
    np.savez(os.path.join(workdir, "inputs.npz"), **mh.inputs())


# -- the plan against the JAX rule --------------------------------------------


def test_plan_matches_the_jax_rule_at_full_width():
    import jax
    import jax.numpy as jnp
    import torch

    import __graft_entry__ as graft
    from hivae_tpu.parallel import create_mesh as jax_create_mesh
    from hivae_tpu.parallel import sharding as jshard
    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.parallel import sharding as tshard
    from hivae_tpu_torch.parallel import tensor_parallel as tp
    from hivae_tpu_torch.utils.params import flax_path_to_torch_key

    jmod = graft._flagship(frames=16)
    lat = (1, 16, 4, jmod.cfg.image_height, jmod.cfg.image_width)
    v = jnp.zeros(lat)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": key, "noise": key}, v, v, v, v))
    jmesh = jax_create_mesh((1, 1, 2))
    want = {}
    for kp, x in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = jshard._path_str(kp)
        spec = tuple(jshard.infer_param_sharding(path, x.shape, jmesh))
        if "tensor" in spec:
            name = flax_path_to_torch_key(tuple(path.split(".")[1:]))
            to_flax = tshard._flax_dims(name, len(x.shape))
            want[name] = to_flax.index(spec.index("tensor"))
    model = tamd.AMDModelNew(tamd.AMDConfig.from_dict(jmod.cfg.to_dict()),
                             device="meta", dtype=torch.float32)
    got, kept = tp.tensor_plan(model, 2)
    assert kept == []
    assert got == want
    # q/k/v, attention out, FFN in and out of every block
    assert len(got) > 100
    assert {n.rsplit(".", 2)[-2] for n in got} == {
        "to_q", "to_k", "to_v", "0", "proj", "2"}


def test_plan_keeps_head_indivisible_blocks_whole():
    """A block whose head count (or width) the extent does not divide
    keeps its weights replicated (the same math); the rest splits."""
    import torch

    from hivae_tpu_torch.models import blocks as B
    from hivae_tpu_torch.parallel import tensor_parallel as tp

    model = torch.nn.ModuleDict({
        "a": B.Attention(48, 3, 16), "b": B.Attention(48, 4, 12),
        "f": B.FeedForward(48, inner_dim=90), "m": B.Mlp(8, 32, 8)})
    got, kept = tp.tensor_plan(model, 4)
    assert sorted(kept) == ["a", "f"]
    assert got == {"b.to_q.weight": 0, "b.to_k.weight": 0,
                   "b.to_v.weight": 0, "b.to_out.0.weight": 1,
                   "m.fc1.weight": 0, "m.fc2.weight": 1}


# -- the ranks ----------------------------------------------------------------


def _modules():
    """(label, module, inputs) of each split block, built the same on
    every rank."""
    import torch

    from hivae_tpu_torch.models import blocks as B

    torch.manual_seed(7)
    x = torch.randn(2, 12, 32)
    ctx = torch.randn(2, 5, 24)
    cross = B.Attention(32, 4, 8, qk_norm=False)
    cross.to_k = torch.nn.Linear(24, 32)
    cross.to_v = torch.nn.Linear(24, 32)
    mods = [("attention", B.Attention(32, 4, 8), (x,)),
            ("cross attention", cross, (x, ctx)),
            ("feed-forward", B.FeedForward(32), (x,)),
            ("mlp", B.Mlp(32, 48, 16), (x,))]
    with torch.no_grad():
        for _, m, _ in mods:
            for p in m.parameters():
                p.add_(0.1 * torch.randn_like(p))
    return mods


def check_modules(mesh):
    """Each split block against its whole twin: output (within
    MODULE_RTOL of its largest entry), input gradients and every
    parameter's gradient (the split ones gathered; within MODULE_RTOL of
    the module's largest gradient entry)."""
    import torch

    from hivae_tpu_torch.parallel.sharding import local
    from hivae_tpu_torch.parallel.tensor_parallel import shard_tensor

    errs = {}
    for label, mod, xs in _modules():
        whole = copy.deepcopy(mod)
        assert shard_tensor(mod, mesh) == []
        outs, grads = [], []
        for m in (mod, whole):
            ins = [x.clone().requires_grad_() for x in xs]
            out = m(*ins)
            w = torch.linspace(-1, 1, out.numel()).view_as(out)
            (out * w).sum().backward()
            outs.append(out.detach())
            grads.append([i.grad for i in ins] +
                         [mh.full(local(p.grad), p)
                          for _, p in sorted(m.named_parameters())])
        assert mod.tp is not None and mod.tp.size == 2
        # gradients against the largest of the module's (a key bias's
        # gradient is zero up to rounding: softmax ignores it)
        g_max = max(h.abs().max() for h in grads[1])
        err = (outs[0] - outs[1]).abs().max() / outs[1].abs().max()
        for g, h in zip(*grads):
            err = max(err, (g - h).abs().max() / g_max)
        errs[label] = float(err)
        assert errs[label] <= MODULE_RTOL, (label, errs[label])
    return errs


def _case(shape):
    """The directory of a mesh's step in the 4-process spawn."""
    return "mesh" + shape.replace(",", "x")


def worker(rank, world, port, workdir, shapes):
    """One rank: a step on each mesh of ``shapes`` (';'-separated) in
    turn; on 2 ranks, one a remat case, then the split modules."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hivae_tpu_torch.parallel.mesh import create_mesh
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    for shape in shapes.split(";"):
        mesh = create_mesh(tuple(int(s) for s in shape.split(",")),
                           device_type="cpu")
        for case in sorted(REMATS) if world == 2 else [_case(shape)]:
            out = mh.port_step(os.path.join(workdir, case), mesh)
            torch.save(out + (dict(sequence_sharded_sdpa.calls),),
                       os.path.join(workdir, case, f"rank{rank}.pt"))
    if world == 2:
        torch.save(check_modules(mesh),
                   os.path.join(workdir, f"modules{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The port's one-rank step on the tiny model without remat: the
    reference of every mesh step here (the remat cases' weights and
    inputs are the same, and remat changes no value)."""
    work = str(tmp_path_factory.mktemp("one"))
    write_tiny(work)
    return mh.one_rank_step(work)


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    """The 2-rank spawn at (1, 1, 2) over every remat case -> workdir."""
    work = str(tmp_path_factory.mktemp("tp"))
    for case, over in REMATS.items():
        write_tiny(os.path.join(work, case), **over)
    run_ranks(os.path.abspath(__file__), 2, [work, "1,1,2"])
    return work


@pytest.mark.parametrize("case", sorted(REMATS))
def test_step_matches_the_one_rank_step(tp_ranks, one_rank, case):
    """The (1, 1, 2) step equals the one-rank step on the same global
    batch; the checkpoint resumed on (1, 1, 2) bit for bit (in the
    ranks) and on one rank with the same parameters."""
    work = os.path.join(tp_ranks, case)
    _, grads, params, calls = mh.check_ranks(work, 2, one_rank, rtol=1e-6)
    assert calls == {"kernel": 0, "plain": 0}   # no ring: weights split
    mh.check_checkpoint_on_one_rank(work, params)


def test_split_modules_match_whole_modules(tp_ranks):
    import torch

    errs = [torch.load(os.path.join(tp_ranks, f"modules{r}.pt"))
            for r in range(2)]
    assert errs[0].keys() == {"attention", "cross attention",
                              "feed-forward", "mlp"}
    for e in errs:
        assert max(e.values()) <= MODULE_RTOL, e


@pytest.fixture(scope="module")
def tp4_ranks(tmp_path_factory):
    """The 4-process spawn over MESHES_4 -> workdir."""
    work = str(tmp_path_factory.mktemp("tp4"))
    for shape in MESHES_4:
        write_tiny(os.path.join(work, _case(shape)))
    run_ranks(os.path.abspath(__file__), 4, [work, ";".join(MESHES_4)])
    return work


def check_4_ranks(work, ref, shape):
    """The 4 ranks' step on ``shape`` against the one-rank step ``ref``
    on the same global batch (loss, grad_norm and every gradient within
    1e-6 relative, every rank's parameters equal); its checkpoint on one
    rank."""
    work = os.path.join(work, _case(shape))
    _, _, params, calls = mh.check_ranks(work, 4, ref, rtol=1e-6)
    assert calls == {"kernel": 0, "plain": 0}   # no ring: weights split
    mh.check_checkpoint_on_one_rank(work, params)


def test_fsdp_with_tensor_parallelism_matches_one_rank(tp4_ranks,
                                                       one_rank):
    """(1, 2, 2): FSDP2 over (data, fsdp) on top of the tensor split."""
    check_4_ranks(tp4_ranks, one_rank, "1,2,2")


def test_data_parallel_with_tensor_parallelism_matches_one_rank(tp4_ranks,
                                                               one_rank):
    """(2, 1, 2): replicated over data, split over tensor; the two ranks
    of a tensor group take the same rows and each tensor index's data
    group averages the gradients' local parts."""
    check_4_ranks(tp4_ranks, one_rank, "2,1,2")


def test_cli_trains_at_mesh_1_1_2_and_one_process_serves(tmp_path,
                                                         monkeypatch):
    """``cli.train_amd --mesh 1,1,2`` in 2 gloo processes (the JAX CLI's
    ``HIVAE_MULTIHOST=1`` variables; ``test_torch_multihost_cli``'s
    ranks): rank 0 alone prints and writes; its checkpoint holds whole
    tensors, which ``cli.amd_inference`` serves in one process."""
    import torch

    import test_torch_multihost_cli as mhc
    from hivae_tpu_torch.cli import amd_inference
    from hivae_tpu_torch.cli import common as cli_common
    from hivae_tpu_torch.models import amd as tamd
    from hivae_tpu_torch.models import vae as tvae
    from hivae_tpu_torch.training import checkpoint as tckpt
    from test_torch_data import _frames, _write_mp4
    from test_torch_train_cli import TINY_FLAGS

    videos = tmp_path / "videos"
    videos.mkdir()
    for i in range(2):
        _write_mp4(videos / f"v{i}.mp4", _frames(i, frames=12, size=mhc.PIX))
    argv = ["--video_dir", str(videos), "--output_dir", str(tmp_path),
            "--exp_name", "run", "--device", "cpu", "--mp", "no",
            "--mesh", "1,1,2", "--train_batch_size", "1",
            "--dataloader_num_workers", "1", "--max_train_steps", "1",
            "--save_checkpoint_interval_step", "1"] + TINY_FLAGS
    outs = mhc._run_cli(tmp_path, argv, "hivae")
    assert "final metrics:" in outs[0] and "final metrics:" not in outs[1]
    run = tmp_path / "run"
    assert os.listdir(run / "checkpoints") == ["checkpoint-1"]
    params = tckpt.load_trained_params(str(run / "checkpoints"))
    cfg = tamd.AMDConfig.from_dict(tckpt.load_config(str(run)))
    whole = {n: p.shape for n, p in
             tamd.AMDModelNew(cfg, device="meta").named_parameters()}
    assert {n: p.shape for n, p in params.items()} == whole
    assert all(torch.isfinite(p).all() for p in params.values())
    monkeypatch.setattr(cli_common, "VAE_CONFIG",
                        tvae.VAEConfig(**mhc.TINY_VAE))
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(videos / "v0.mp4", one / "v0.mp4")
    assert amd_inference.main([
        "--amd_config", str(run / "config.json"),
        "--amd_ckpt", str(run / "checkpoints"), "--video_dir", str(one),
        "--output_dir", str(tmp_path / "recon"), "--video_frames",
        str(mhc.T), "--sample_step", "1", "--device", "cpu"]) == 0
    assert (tmp_path / "recon" / "v0_recon.mp4").stat().st_size > 0


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(*map(int, sys.argv[2:5]), *sys.argv[5:])
