"""The blocks and DiTs no model of the repository builds, against the JAX
package on the CPU, and the bridge's reading of a scanned parameter tree
against the JAX package's ``unstack_scanned``.

``Any2MotionBlock``, ``RefMotionRefImageBlock``, ``MotionTransferBlock``
and ``AudioToImageShapeMlp`` (``models/blocks.py``), ``VelocityDiTSplitInput``
and ``DiT2Condition`` (``models/dit.py``): each JAX module's parameters come
from ``jax.eval_shape`` of its init, filled by numpy (nothing compiles but
one jitted apply), and load into the port's module through the bridge
(``utils/params.flax_to_torch``) with no missing or unexpected key; the
outputs agree in fp32 within 2e-4 of their largest element, as the model
tests hold them. ``DiT2Condition`` runs on a non-square latent grid
(8 x 4), which pins its image table's (iph, iph) layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.models import amd as jamd
from hivae_tpu.models import blocks as jblocks
from hivae_tpu.models import dit as jdit
from hivae_tpu.ops.quant import unstack_scanned
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import blocks as tblocks
from hivae_tpu_torch.models import dit as tdit
from hivae_tpu_torch.utils.params import flax_to_torch

KEY = jax.random.PRNGKey(0)
DIM, HEADS, HEAD_DIM, COND = 32, 2, 16, 24


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def numpy_params(module, *args, seed=0):
    """The module's parameter tree from ``eval_shape`` of its init, filled
    by numpy (0.2 scale, so nothing sits at a zero or unit init)."""
    shapes = jax.eval_shape(lambda: module.init(
        KEY, *(jnp.asarray(a) for a in args)))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (0.2 * rng.randn(*s.shape)).astype(
        np.float32), shapes)


def run_both(jmod, tmod, args, seed=0):
    """Load the port's module from the JAX tree (strict) and return both
    outputs, flattened to tuples of numpy arrays."""
    params = numpy_params(jmod, *args, seed=seed)
    tmod.load_state_dict(flax_to_torch(params), strict=True)
    want = jax.jit(jmod.apply)(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tmod.eval()(*(torch.from_numpy(a) for a in args))
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    return ([np.asarray(w) for w in as_tuple(want)],
            [g.numpy() for g in as_tuple(got)])


def assert_close(got, want, tol=2e-4):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


BLOCKS = {
    "Any2MotionBlock": (
        lambda: jblocks.Any2MotionBlock(DIM, HEADS, HEAD_DIM,
                                        motion_frames=3),
        lambda: tblocks.Any2MotionBlock(DIM, HEADS, HEAD_DIM, COND,
                                        motion_frames=3),
        lambda: (rand(6, 5, DIM), rand(6, 4, DIM, seed=1),
                 rand(6, 7, DIM, seed=2), rand(6, COND, seed=3))),
    "RefMotionRefImageBlock": (
        lambda: jblocks.RefMotionRefImageBlock(DIM, HEADS, HEAD_DIM),
        lambda: tblocks.RefMotionRefImageBlock(DIM, HEADS, HEAD_DIM, COND),
        lambda: (rand(2, 9, DIM), rand(2, 4, DIM, seed=1),
                 rand(2, 6, DIM, seed=2), rand(2, COND, seed=3))),
    "MotionTransferBlock": (
        lambda: jblocks.MotionTransferBlock(DIM, HEADS, HEAD_DIM),
        lambda: tblocks.MotionTransferBlock(DIM, HEADS, HEAD_DIM, COND),
        lambda: (rand(2, 5, DIM), rand(2, 11, DIM, seed=1),
                 rand(2, COND, seed=3))),
    "AudioToImageShapeMlp": (
        lambda: jblocks.AudioToImageShapeMlp(4, 3, 2),
        lambda: tblocks.AudioToImageShapeMlp(5 * 6, 4, 3, 2),
        lambda: (rand(2, 3, 5, 6),)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jmake, tmake, args = BLOCKS[name]
    want, got = run_both(jmake(), tmake(), args())
    assert_close(got, want)


DIT_KW = dict(heads=HEADS, head_dim=HEAD_DIM, out_channels=4, num_layers=2,
              image_patch_size=2, image_in_channels=4, motion_in_channels=8,
              time_embed_dim=COND)


def test_velocity_dit_split_input_matches_jax():
    """zi and zt of 8 x 8 latents (16 patches each) beside a 4 x 4 grid
    of motion tokens."""
    jmod = jdit.VelocityDiTSplitInput(**DIT_KW)
    tmod = tdit.VelocityDiTSplitInput(**DIT_KW)
    args = (rand(2, 8, 4, 4), rand(2, 8, 8, 8, seed=1),
            np.array([3.0, 700.0], np.float32))
    want, got = run_both(jmod, tmod, args, seed=4)
    assert_close(got, want)


@pytest.mark.parametrize("grid", [(8, 8), (8, 4)], ids=["square", "8x4"])
def test_dit_2condition_matches_jax(grid):
    """On a non-square grid the image table is still (iph, iph): the
    reference image reads rows [iph * ipw, 2 iph * ipw) of it."""
    h, w = grid
    jmod = jdit.DiT2Condition(motion_frames=3, **DIT_KW)
    tmod = tdit.DiT2Condition(motion_frames=3, **DIT_KW)
    args = (rand(2, 4, h, w), rand(2, 4, h, w, seed=1),
            rand(2, 8, 4, 2, seed=2), np.array([10.0, 500.0], np.float32))
    want, got = run_both(jmod, tmod, args, seed=5)
    assert_close(got, want)


def test_grid_dits_route_to_the_full_block_kernel():
    """At 32^2 latents with patch 2 both attend jointly over 512 patches
    and the motion grid: above 256^2 logits, the full-block kernel (on
    ``meta`` tensors, which stand in for the card, in bf16)."""
    from hivae_tpu_torch.ops import attention as tattn
    for tokens in (512 + 16, 256 + 256 + 16):
        x = torch.empty((2, 20, tokens, 64), device="meta",
                        dtype=torch.bfloat16)
        assert tattn.kernel_route(x, x, x) == "full_block"


def test_scanned_tree_bridges_as_unstack_scanned_of_it():
    """The port's counterpart of ``unstack_scanned`` is the bridge itself:
    a ``scan_layers=True`` tree of the tiny flagship (the spatial DiT's
    ``layers/{object,camera,spatial}_block`` stacks) maps onto the same
    state dict as JAX's ``unstack_scanned`` of it, which loads into a
    ``scan_layers=False`` port model with no missing or unexpected key."""
    base = graft._flagship(tiny=True, frames=4).cfg
    scanned = jamd.AMDModelNew(cfg=base.replace(scan_layers=True))
    v = jnp.zeros((1, 4, 4, 16, 16))
    shapes = jax.eval_shape(lambda: scanned.init(
        {"params": KEY, "noise": KEY}, v, v, v, v))
    rng = np.random.RandomState(6)
    tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                        shapes)
    dit = tree["params"]["diffusion_transformer"]
    assert set(dit["layers"]) == {"object_block", "camera_block",
                                  "spatial_block"}
    unrolled = {"params": unstack_scanned(tree["params"],
                                          base.diffusion_num_layers)}
    direct, via = flax_to_torch(tree), flax_to_torch(unrolled)
    assert direct.keys() == via.keys()
    assert all(torch.equal(direct[k], via[k]) for k in direct)
    port = tamd.AMDModelNew(tamd.AMDConfig.from_dict(
        base.replace(scan_layers=False).to_dict()), device="cpu")
    port.load_state_dict(via, strict=True)
