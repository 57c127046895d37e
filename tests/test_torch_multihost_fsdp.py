"""One training step of the port on the mesh (1, 2, 1), FSDP2 over 2
gloo processes, against the JAX trainer's step on the same mesh over fake
devices and the port's 1-rank step, and its checkpoint (the whole state,
gathered from the shards) on one rank; the helpers and tolerances of
``test_torch_multihost.py``. Also ``validate`` on the sharded model (the
samplers call the model's methods, which gather its parameters as a
forward does) between two steps, which must leave the second step as it
is without it."""

import os
import sys

import numpy as np
import pytest

import test_torch_multihost as mh
from test_torch_ring import run_ranks


@pytest.fixture(scope="module")
def tiny():
    return mh.make_tiny()


def test_fsdp_step_matches_jax_trainer(tiny, tmp_path):
    mh.check_mesh_step(tiny, (1, 2, 1), tmp_path)


def worker(rank, world, port, workdir):
    """Two steps with and without ``validate`` between them."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hivae_tpu_torch.parallel.mesh import create_mesh
    from hivae_tpu_torch.parallel.sharding import batch_rows

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = create_mesh((1, 2, 1), device_type="cpu")
    x = dict(np.load(os.path.join(workdir, "inputs.npz")))
    batch = {k: v[batch_rows(mesh, mh.N)] for k, v in mh._batch(x).items()}
    losses, frames = [], None
    for validate in (False, True):
        trainer = mh._trainer(workdir, mesh, f"out{int(validate)}")
        trainer.train_step(batch)
        if validate:
            frames = trainer.validate(batch, sample_step=1)
        losses.append(trainer.train_step(batch)["loss"])
    assert losses[0] == losses[1], losses
    assert frames.dtype == np.uint8 and frames.shape == (1, mh.T, 3, mh.PIX,
                                                         mh.PIX)
    dist.destroy_process_group()


def test_validate_on_the_sharded_model(tiny, tmp_path):
    mh.write_inputs(tiny, str(tmp_path))
    run_ranks(os.path.abspath(__file__), 2, [tmp_path])


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(*map(int, sys.argv[2:5]), *sys.argv[5:])
