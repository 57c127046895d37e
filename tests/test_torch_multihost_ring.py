"""One training step of the port on the mesh (1, 1, 2) with
``attn_impl="ring"`` against the JAX trainer's step on the same mesh over
fake devices, on the CPU at the tiny config (the helpers and tolerances
of ``test_torch_multihost.py``). Every attention call of the step (the
VAE encodes', the encoders', the DiT's) divides by the ring of 2, so every
one runs sequence-sharded over the 2 gloo processes, each on the whole
global batch."""

import pytest

import test_torch_multihost as mh
from test_torch_ring import run_ranks


@pytest.fixture(scope="module")
def tiny():
    return mh.make_tiny()


def test_ring_mesh_step_matches_jax_trainer(tiny, tmp_path):
    shape = (1, 1, 2)
    x = mh.write_inputs(tiny, str(tmp_path), attn_impl="ring")
    run_ranks(mh.__file__, 2, [tmp_path, "1,1,2"])
    # the 1-rank reference runs auto attention: the ring changes the order
    # of the softmax sums only
    ref = mh.one_rank_step(str(tmp_path))
    metrics, grads, params, calls = mh.check_ranks(str(tmp_path), 2, ref,
                                                   rtol=2e-6)
    # every attention of the two forwards (loss_and_grads, train_step)
    # rings: 4 VAE encodes, each encoder layer, 3 DiT attentions a layer
    cfg = tiny["jmod"].cfg
    per_step = 4 + cfg.object_enc_num_layers + cfg.camera_enc_num_layers + \
        3 * cfg.diffusion_num_layers
    assert calls == {"kernel": 0, "plain": 2 * per_step}
    jmetrics, jparams = mh.jax_step(tiny, x, shape, str(tmp_path),
                                    attn_impl="ring")
    mh.check_step_against_jax(tiny, metrics, grads, params, jmetrics,
                              jparams)
