"""The port's mesh, sharding rules, batch rows and attention routing
against the JAX package's ``hivae_tpu/parallel`` and ``ops/attention.py``,
on the CPU (no process group: the multi-rank paths are held in
``test_torch_ring.py`` and ``test_torch_multihost*.py``).

The sharding rule is compared on the tiny config's parameters: each flax
path and shape goes through the JAX ``infer_param_sharding``; its torch
name (the bridge's name map, ``utils/params.py``) and torch layout go
through the port's, whose spec must be the JAX spec moved through the
layout. Routing is read on ``meta`` tensors, which stand in for the card
(the kernels' gate asks ``fa.takes``)."""

import os
import re
import types
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from hivae_tpu.models import amd as jamd
from hivae_tpu.parallel import create_mesh as jax_create_mesh
from hivae_tpu.parallel import sharding as jshard
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.ops import attention as A
from hivae_tpu_torch.parallel import mesh as tmesh
from hivae_tpu_torch.parallel import sharding as tshard
from hivae_tpu_torch.utils.params import flax_path_to_torch_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def attn_state():
    """Restore the process-wide attention implementation and ring."""
    saved = (A._DEFAULT_IMPL, A._RING_MESH, A._RING_AXIS)
    yield
    A._DEFAULT_IMPL, A._RING_MESH, A._RING_AXIS = saved


def _fake_mesh(d, f, t, dp_index=0):
    shape = {"data": d, "fsdp": f, "tensor": t}
    return types.SimpleNamespace(shape=shape, dp_size=d * f,
                                 dp_index=dp_index)


# -- mesh ---------------------------------------------------------------------


def test_create_mesh_without_a_process_group():
    for shape in (None, (1, 1, 1)):
        mesh = tmesh.create_mesh(shape)
        assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1}
        assert mesh.device_mesh is None and mesh.group("tensor") is None
        assert (mesh.size, mesh.dp_size, mesh.dp_index) == (1, 1, 0)
        assert mesh.is_first
    assert tmesh.local_mesh().shape == jax_create_mesh((1, 1, 1)).shape
    for bad, msg in (((2, 1, 1), "process group has 1"),
                     ((1, 1), "three positive"), ((1, 0, 1), "three")):
        with pytest.raises(ValueError, match=msg):
            tmesh.create_mesh(bad)


def test_init_distributed_needs_a_launch(monkeypatch):
    for var in ("HIVAE_MULTIHOST", "HIVAE_COORDINATOR", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not tmesh.launched()
    with pytest.raises(RuntimeError, match="no launch found"):
        tmesh.init_distributed(device="cpu")
    monkeypatch.setenv("HIVAE_MULTIHOST", "1")
    assert tmesh.launched()
    with pytest.raises(RuntimeError, match="no launch found"):
        tmesh.init_distributed(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tmesh.init_distributed()


# -- sharding rules -----------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_paths():
    """(flax path string, flax shape) of every tiny-config parameter, and
    the port model's parameter shapes by name."""
    jmod = graft._flagship(tiny=True, frames=4)
    v = jnp.zeros((1, 4, 4, 16, 16))
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(0)},
        v, v, v, v))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    cfg = tamd.AMDConfig.from_dict(jmod.cfg.to_dict())
    model = tamd.AMDModelNew(cfg, device="cpu")
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return [(jshard._path_str(kp), tuple(x.shape)) for kp, x in leaves], port


@pytest.mark.parametrize("shape,min_size", [
    ((2, 2, 2), 2 ** 16), ((1, 8, 1), 2 ** 16), ((1, 2, 1), 2 ** 10),
    ((1, 1, 4), 2 ** 10), ((2, 2, 2), 2 ** 8)])
def test_infer_param_sharding_matches_jax(tiny_paths, shape, min_size):
    _rule_matches_jax(*tiny_paths, shape, min_size)


def test_infer_param_sharding_matches_jax_on_amd_s_tiny():
    """The dual-encoder AMDModel (the pair-temporal encoders' motion
    blocks, the KL maps, the dual-stream DiT's temporal motion blocks) at
    the tiny widths, one mesh."""
    from test_torch_amd_family import TINY

    jmod = jamd.AMDModel(cfg=jamd.AMDConfig(
        **TINY, use_filter=True, use_regularizers=True,
        diffusion_model_type="dual"))
    v = jnp.zeros((1, 4, 4, 16, 16))
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmod.init(
        {"params": key, "noise": key, "noise_kl": key}, v, v))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    model = tamd.AMDModel(tamd.AMDConfig.from_dict(jmod.cfg.to_dict()),
                          device="meta")
    port = {n: tuple(p.shape) for n, p in model.named_parameters()}
    _rule_matches_jax([(jshard._path_str(kp), tuple(x.shape))
                       for kp, x in leaves], port, (1, 2, 1), 2 ** 10)


def _rule_matches_jax(paths, port, shape, min_size):
    jmesh = jax_create_mesh(shape)
    tmesh_shape = dict(zip(tmesh.AXES, shape))
    sharded = 0
    for path, fshape in paths:
        want = tuple(jshard.infer_param_sharding(path, fshape, jmesh,
                                                 min_size))
        want += (None,) * (len(fshape) - len(want))
        name = flax_path_to_torch_key(tuple(path.split(".")[1:]))
        to_flax = tshard._flax_dims(name, len(fshape))
        tshape = tuple(fshape[fd] for fd in to_flax)
        assert port[name] == tshape, name
        got = tshard.infer_param_sharding(name, tshape, tmesh_shape,
                                          min_size)
        assert got == tuple(want[fd] for fd in to_flax), (name, got, want)
        sharded += any(got)
    assert len(paths) == len(port)
    assert sharded > 0


def test_batch_rows_match_batch_sharding():
    """The rows of each (data, fsdp) index are the rows the JAX
    ``batch_sharding`` puts on the device at that mesh position."""
    n = 8
    for shape in ((4, 2, 1), (2, 1, 2), (1, 2, 2)):
        jmesh = jax_create_mesh(shape)
        index = jshard.batch_sharding(jmesh).devices_indices_map((n, 3))
        d, f, t = shape
        for di in range(d):
            for fi in range(f):
                for ti in range(t):
                    dev = jmesh.devices[di, fi, ti]
                    rows = tshard.batch_rows(
                        _fake_mesh(d, f, t, di * f + fi), n)
                    assert index[dev][0] == rows, (shape, di, fi, ti)
    with pytest.raises(ValueError, match="must be divisible by the "
                       "data-parallel extent 4"):
        tshard.batch_rows(_fake_mesh(2, 2, 1), 6)


def test_weight_tensor_parallelism_is_refused(tiny_paths):
    """Named for the refusal it replaced: a 'tensor' extent is now taken
    (``create_mesh`` refuses only a shape whose ranks are not the
    process group's, or an extent below 1), and the tiny model's split
    weights are the ones the JAX rule shards on 'tensor', on the same
    dims."""
    from hivae_tpu_torch.parallel import tensor_parallel as ttp

    for shape in ((1, 1, 2), (2, 1, 2), (1, 2, 2)):
        with pytest.raises(ValueError, match="the process group has 1"):
            tmesh.create_mesh(shape)
    with pytest.raises(ValueError, match="three positive extents"):
        tmesh.create_mesh((2, 1, 0))
    jmesh = jax_create_mesh((1, 1, 2))
    want = {}
    for path, fshape in tiny_paths[0]:
        spec = tuple(jshard.infer_param_sharding(path, fshape, jmesh))
        if "tensor" in spec:
            name = flax_path_to_torch_key(tuple(path.split(".")[1:]))
            want[name] = tshard._flax_dims(name, len(fshape)).index(
                spec.index("tensor"))
    cfg = tamd.AMDConfig.from_dict(
        graft._flagship(tiny=True, frames=4).cfg.to_dict())
    got, kept = ttp.tensor_plan(tamd.AMDModelNew(cfg, device="meta"), 2)
    assert kept == [] and got == want and len(got) > 20


# -- sdpa(implementation=) routing --------------------------------------------


def _meta(s, d=64, dtype=torch.bfloat16, sk=None):
    q = torch.empty((2, 4, s, d), device="meta", dtype=dtype)
    k = torch.empty((2, 4, sk or s, d), device="meta", dtype=dtype)
    return q, k


ROUTES = {  # (S, D, dtype): route under auto, xla, pallas
    (16, 64, torch.bfloat16): ("plain", "plain", "full_block"),
    (300, 64, torch.bfloat16): ("full_block", "plain", "full_block"),
    (2048, 64, torch.bfloat16): ("stream", "plain", "stream"),
    (300, 64, torch.float32): ("full_block", "plain", "full_block"),
    (300, 64, torch.float16): ("full_block", "plain", "full_block"),
    (300, 80, torch.bfloat16): ("full_block", "plain", "full_block"),
    (300, 2056, torch.float16): ("plain", "plain", "plain"),
    (300, 12, torch.bfloat16): ("plain", "plain", "plain"),
}


@pytest.mark.parametrize("key", sorted(ROUTES, key=str))
def test_sdpa_implementation_routing(key, attn_state):
    """Where each implementation sends a call on the card, and which plain
    calls count in ``sdpa_plain``: those where the JAX package's
    implementation would run a Pallas kernel (D a multiple of 8; above
    256^2 logits under auto, at any size under pallas), never under
    xla."""
    s, d, dtype = key
    q, k = _meta(s, d, dtype)
    for impl, want in zip(("auto", "xla", "pallas"), ROUTES[key]):
        assert A.kernel_route(q, k, k, impl) == want, impl
        A.set_default_implementation(impl)
        assert A.kernel_route(q, k, k) == want, impl
        if want == "plain":
            before = A.sdpa_plain.launches
            out = A.sdpa(q, k, k, implementation=impl)
            assert out.shape == q.shape
            counted = impl != "xla" and d % 8 == 0 and (
                impl == "pallas" or s * s > A.KERNEL_MIN_LOGITS)
            assert A.sdpa_plain.launches == before + int(counted), impl
    with pytest.raises(ValueError, match="attention implementation"):
        A.set_default_implementation("flash")


def test_ring_routing_and_fallback(attn_state):
    q, k = _meta(300)
    A.set_ring_context(None)
    with pytest.warns(UserWarning, match="no ring mesh"):
        A.sdpa(*_meta(300, d=2056, dtype=torch.float16)[:1] * 3,
               implementation="ring")
    A.set_ring_context(_fake_mesh(1, 1, 4))
    assert A.kernel_route(q, k, k, "ring") == "ring"
    # 300 does not divide by a ring of 8: auto's route, with one warning
    # a shape
    A.set_ring_context(_fake_mesh(1, 1, 8))
    assert A.kernel_route(q, k, k, "ring") == "full_block"
    x = _meta(300, d=2056, dtype=torch.float16)[0]
    before = A.sdpa_plain.launches
    with pytest.warns(UserWarning, match="don't divide"):
        A.sdpa(x, x, x, implementation="ring")
    assert A.sdpa_plain.launches == before + 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        A.sdpa(x, x, x, implementation="ring")


def test_ring_kernel_hop_routing():
    """The ring's hop choice on ``meta`` tensors, which stand in for the
    card: under auto a bf16 block of 1024 local tokens or more takes the
    kernel hop, and so does an fp32 one, with a gradient or without (the
    streaming kernels' fp32 siblings), and so does fp16 and a head dim off
    the tiles (their fp16 forms; D 72 on the 128 tile); one the kernels
    refuse (D 2056, past every tile), where the JAX package runs its Pallas
    hop, takes the plain hop and counts in ``sdpa_plain.launches``; under
    1024 tokens the plain hop, uncounted; a CPU tensor of any dtype the
    kernel hop's plain versions."""
    from hivae_tpu_torch.parallel.ring_attention import _kernel_hop

    def blocks(s, d=64, dtype=torch.bfloat16):
        x = torch.empty((1, 2, s, d), device="meta", dtype=dtype)
        return x, x, x

    before = A.sdpa_plain.launches
    assert _kernel_hop(*blocks(1024), "auto")
    assert not _kernel_hop(*blocks(512), "auto")
    assert not _kernel_hop(*blocks(512, dtype=torch.float32), "auto")
    assert A.sdpa_plain.launches == before
    assert _kernel_hop(*blocks(1024, dtype=torch.float32), "auto")
    assert A.sdpa_plain.launches == before
    fp32_grad = torch.empty((1, 2, 1024, 64), device="meta",
                            requires_grad=True)
    assert _kernel_hop(*(fp32_grad,) * 3, "auto")
    assert A.sdpa_plain.launches == before
    for args in (blocks(2048, dtype=torch.float16), blocks(1024, d=72)):
        assert _kernel_hop(*args, "auto")
    assert A.sdpa_plain.launches == before
    for args in (blocks(2048, d=2056, dtype=torch.float16),
                 blocks(1024, d=2056)):
        assert not _kernel_hop(*args, "auto")
    assert A.sdpa_plain.launches == before + 2
    assert _kernel_hop(*(torch.zeros(1, 2, 1024, 8),) * 3, "auto")
    assert _kernel_hop(*blocks(16), "flash")
    assert not _kernel_hop(*blocks(4096), "xla")
    assert A.sdpa_plain.launches == before + 2


def test_ring_refuses_a_group_that_is_not_the_mesh_axis():
    """A ring whose process group does not match the mesh's 'tensor'
    extent raises (here: no process group for an extent of 2), as does a
    sequence the ring cannot split."""
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa

    x = torch.zeros((1, 2, 8, 4))
    fake = types.SimpleNamespace(shape={"data": 1, "fsdp": 1, "tensor": 2},
                                 group=lambda axis: None)
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        sequence_sharded_sdpa(x, x, x, fake)
    with pytest.raises(ValueError, match="ring impl"):
        sequence_sharded_sdpa(x, x, x, tmesh.local_mesh(), impl="pallas")
    # a ring of one rank is attention itself
    q, k, v = (torch.randn(1, 2, 8, 4) for _ in range(3))
    out = sequence_sharded_sdpa(q, k, v, tmesh.local_mesh())
    want = A.sdpa(q, k, v, implementation="xla")
    assert torch.allclose(out, want, atol=1e-6)


def test_install_attn_impl(attn_state):
    for impl in ("xla", "pallas", "auto"):
        A.install_attn_impl(tamd.AMDConfig(attn_impl=impl))
        assert A._DEFAULT_IMPL == impl
    # a ring of one rank (no process group) degrades to auto, as the JAX
    # package's install_attn_impl does on a 1-extent 'tensor' axis
    with pytest.warns(UserWarning, match="using 'auto'"):
        A.install_attn_impl(tamd.AMDConfig(attn_impl="ring"))
    assert A._DEFAULT_IMPL == "auto"
    A.install_attn_impl(tamd.AMDConfig(attn_impl="ring"),
                        _fake_mesh(1, 1, 2))
    assert A._DEFAULT_IMPL == "ring" and A._RING_MESH.shape["tensor"] == 2


def test_the_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (hivae_tpu), not even a module of it without jax."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|hivae_tpu)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "hivae_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{path}:{i}: {line.strip()}"
                    for i, line in enumerate(f, 1) if pat.match(line)]
    assert len(files) > 40 and not bad, bad
