"""The port's ring attention against the JAX package's
``sequence_sharded_sdpa`` on the CPU: the JAX side on its fake-device
mesh (the Pallas hop in interpret mode), the port's in 2 or 4 processes
over gloo (its kernel hop on the kernels' plain versions), on the same
numpy-seeded q, k, v, in fp32.

Meshes (1, 1, 4) and (1, 1, 2) ring the whole batch; (2, 1, 2) rings each
half of it (the JAX ``batch_axis="data"``; each port rank holds its
``batch_rows``). Both hop kinds (``impl`` xla and flash), masked and
unmasked; the mask drops a whole local block of one row, so that hop
merges with weight 0. Outputs within 2e-5 and the gradients of
sum(out * w) within 1e-4, each rank's rows against the JAX rows.

Each spawned process has a timeout, so a hung collective fails the test,
not the suite.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

B, H, S, D = 2, 2, 64, 16
CASES = [("xla", False), ("xla", True), ("flash", False), ("flash", True)]
MESHES = {(1, 1, 4): CASES, (2, 1, 2): CASES,
          (1, 1, 2): [("xla", False), ("flash", True)]}
OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
RANK_TIMEOUT = 240


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, H, S, D).astype(np.float32)
                  for _ in range(4))
    mask = rng.rand(B, S) < 0.7
    mask[0, :S // 4] = False        # rank 0's whole block of row 0 (P 4)
    mask[:, -1] = True
    return dict(q=q, k=k, v=v, w=w, mask=mask)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script, world, args, timeout=RANK_TIMEOUT, ok=True):
    """Run ``script worker <rank> <world> <port> *args`` in ``world``
    processes -> their outputs; kill them all and fail if any exceeds
    ``timeout`` s, or if any exits non-zero (``ok``) or zero (not
    ``ok``)."""
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, script, "worker", str(r), str(world), port]
        + [str(a) for a in args], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a rank of {script} ran past {timeout} s")
    for p, out in zip(procs, outs):
        assert (p.returncode == 0) == ok, out[-4000:]
    return outs


# -- the port's side (a rank) -------------------------------------------------


def worker(rank, world, port, workdir, shape):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from hivae_tpu_torch.parallel.mesh import create_mesh
    from hivae_tpu_torch.parallel.ring_attention import sequence_sharded_sdpa
    from hivae_tpu_torch.parallel.sharding import batch_rows

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    shape = tuple(int(x) for x in shape.split(","))
    mesh = create_mesh(shape, device_type="cpu")
    rows = batch_rows(mesh, B)
    x = {k: torch.from_numpy(a[rows]) for k, a in _inputs().items()}
    got = {"coords": np.array([mesh.coordinate(a) for a in
                               ("data", "fsdp", "tensor")] +
                              [mesh.dp_index, rows.start, rows.stop])}
    for impl, masked in MESHES[shape]:
        q, k, v = (x[n].clone().requires_grad_() for n in "qkv")
        out = sequence_sharded_sdpa(q, k, v, mesh,
                                    key_mask=x["mask"] if masked else None,
                                    impl=impl)
        (out * x["w"]).sum().backward()
        for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad),
                        ("dv", v.grad)):
            got[f"{impl}_{masked}_{name}"] = t.detach().numpy()
    want = {"kernel": sum(1 for i, _ in MESHES[shape] if i == "flash")}
    want["plain"] = len(MESHES[shape]) - want["kernel"]
    assert sequence_sharded_sdpa.calls == want, sequence_sharded_sdpa.calls
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **got)
    dist.destroy_process_group()


# -- the JAX side -------------------------------------------------------------


def _jax_ring(shape, impl, masked):
    import jax
    import jax.numpy as jnp

    from hivae_tpu.parallel import create_mesh
    from hivae_tpu.parallel.ring_attention import sequence_sharded_sdpa

    x = {k: jnp.asarray(a) for k, a in _inputs().items()}
    mesh = create_mesh(shape)
    batch_axis = "data" if shape[0] > 1 else None
    mask = x["mask"] if masked else None

    def loss(q, k, v):
        out = sequence_sharded_sdpa(q, k, v, mesh, batch_axis=batch_axis,
                                    key_mask=mask, impl=impl)
        return jnp.sum(out * x["w"]), out

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(x["q"], x["k"], x["v"])
    return dict(zip(("out", "dq", "dk", "dv"),
                    [np.asarray(out)] + [np.asarray(g) for g in grads]))


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_ring_matches_jax(shape, tmp_path):
    world = shape[0] * shape[1] * shape[2]
    run_ranks(os.path.abspath(__file__), world,
              [tmp_path, ",".join(map(str, shape))])
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    d, f, t = shape
    for r, got in enumerate(ranks):
        # ranks are laid out row-major over (data, fsdp, tensor)
        di, ti = r // (f * t), r % t
        per = B // (d * f)
        assert got["coords"].tolist() == [di, 0, ti, di, di * per,
                                          (di + 1) * per], r
    for impl, masked in MESHES[shape]:
        want = _jax_ring(shape, impl, masked)
        for r, got in enumerate(ranks):
            lo, hi = got["coords"][4:6]
            for name, ref in want.items():
                atol = OUT_ATOL if name == "out" else GRAD_ATOL
                np.testing.assert_allclose(
                    got[f"{impl}_{masked}_{name}"], ref[lo:hi], rtol=0,
                    atol=atol, err_msg=f"rank {r} {impl} masked={masked} "
                    f"{name}")


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(*map(int, sys.argv[2:5]), *sys.argv[5:])
