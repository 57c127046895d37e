"""``cli.export_sampler`` on ``torch.export``, on the CPU: the clip sampler
(``ClipSampler``, the body of ``pipelines.reconstruct_clip``) exported
with the attention kernels as ``torch.library`` custom ops in the graph
(the ``pallas`` implementation sends every attention call of the tiny
config to a kernel's op, whose CPU implementation is the plain version),
saved, loaded and run.

* fp32, against the JAX package's ``_recon_clip`` on the same weights,
  pixels and Euler start noise: uint8 within one level on 99% of the
  values, as ``test_torch_pipeline.py`` holds the live sampler;
* int8 (``--quant int8``'s tables as module buffers, the float weights
  they replace stripped) and the CLI in bf16 with ``--check``: the loaded
  program's frames against the live sampler's on the same inputs, within
  one level on 99% of the values (the CPU's matmuls may round a value on
  a quantisation edge otherwise between two runs), and the fused int8
  FFN-up as ``hivae::ffn_up_quant`` in an exported graph."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivae_tpu.pipelines.pipeline import _recon_clip
from hivae_tpu_torch.cli import export_sampler
from hivae_tpu_torch.models import amd as tamd
from hivae_tpu_torch.models import blocks as tblocks
from hivae_tpu_torch.models import vae as tvae
from hivae_tpu_torch.ops import attention as tattn
from hivae_tpu_torch.ops import quant as tquant
from test_torch_pipeline import FRAMES, SIZE, _clip, stacks  # noqa: F401
from test_torch_serving_io import (VAE_CFG, amd, serving_files,  # noqa
                                   tiny_cli_vae, tiny_vae)
from test_torch_serving_pipelines import _same_uint8


@pytest.fixture
def kernel_ops():
    """Every attention call to a kernel's custom op, for the test."""
    tattn.set_default_implementation("pallas")
    yield
    tattn.set_default_implementation("auto")


def _hivae_ops(program):
    return {str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and "hivae" in str(n.target)}


def _round_trip(sampler, inputs, tmp_path):
    program = export_sampler.export(sampler, inputs)
    path = str(tmp_path / "sampler.pt2")
    torch.export.save(program, path)
    loaded = torch.export.load(path)
    with torch.no_grad():
        return program, loaded.module()(*inputs), sampler(*inputs)


def test_exported_sampler_matches_jax(stacks, kernel_ops, tmp_path):
    jvae_mod, jamd_mod, vae_params, amd_params, tvae_mod, tamd_mod = stacks
    pixels, grey = _clip(5)
    key = jax.random.PRNGKey(9)
    want = np.asarray(_recon_clip(
        jvae_mod, jamd_mod, vae_params, amd_params, jnp.asarray(pixels),
        jnp.asarray(grey), key, sample_step=2, use_grey=True))
    _, knoise = jax.random.split(key)
    noise = np.array(jax.random.normal(knoise, (FRAMES, 4, 16, 16)))
    sampler = export_sampler.ClipSampler(tvae_mod, tamd_mod, 2).eval()
    inputs = tuple(torch.from_numpy(x) for x in (pixels, grey, noise))
    program, got, live = _round_trip(sampler, inputs, tmp_path)
    assert "hivae.full_block_attention.default" in _hivae_ops(program)
    _same_uint8(got.numpy(), want)
    _same_uint8(got.numpy(), live.numpy())


def _tiny_pair(dtype):
    import __graft_entry__ as graft
    cfg = tamd.AMDConfig.from_dict(
        graft._flagship(tiny=True, frames=FRAMES).cfg.to_dict())
    torch.manual_seed(0)
    amd = tamd.AMDModelNew(cfg, device="cpu", dtype=dtype).eval()
    vae = tvae.AutoencoderKL(tvae.VAEConfig(**VAE_CFG), device="cpu",
                             dtype=dtype).eval()
    return amd, vae


def test_int8_sampler_round_trip(kernel_ops, monkeypatch, tmp_path):
    """The tiny widths are under the int8 size predicate's 512: its
    threshold is lowered to 32 so that the DiT and the VAE decoder have
    tables."""
    pred = tquant.default_predicate
    monkeypatch.setattr(tquant, "default_predicate",
                        lambda n, w: pred(n, w, min_dim=32))
    amd, vae = _tiny_pair(torch.bfloat16)
    sampler = export_sampler.build_sampler(vae, amd, 1, "int8")
    assert sampler.quant_table.table() and sampler.vae_quant_table.table()
    assert any(b.dtype == torch.int8 for b in sampler.buffers())
    pix, _, noise = export_sampler.example_inputs(amd, FRAMES, SIZE, "cpu")
    g = torch.Generator().manual_seed(1)
    pix = torch.rand(pix.shape, generator=g) * 2 - 1
    program, got, live = _round_trip(sampler, (pix, pix.clone(), noise),
                                     tmp_path)
    assert got.dtype == torch.uint8 and got.shape == (FRAMES + 1, 3, SIZE,
                                                      SIZE)
    _same_uint8(got.numpy(), live.numpy())
    assert "hivae.full_block_attention.default" in _hivae_ops(program)


def test_int8_ffn_exports_as_the_op():
    """A feed-forward whose widths the fused kernel takes (multiples of
    128) runs ``hivae::ffn_up_quant`` under its int8 table, in the graph
    too."""
    torch.manual_seed(2)
    ff = tblocks.FeedForward(128).eval()
    table = tquant.quantize_params(ff, predicate=lambda n, w: True,
                                   scope=None)

    class M(torch.nn.Module):
        def forward(self, x):
            with tquant.quantized_calls(ff, table):
                return ff(x)

    x = torch.randn(2, 5, 128)
    with torch.no_grad():
        program = torch.export.export(M(), (x,))
        assert torch.equal(program.module()(x), M()(x))
    assert "hivae.ffn_up_quant.default" in _hivae_ops(program)


def test_export_sampler_cli_check(serving_files, tiny_cli_vae, kernel_ops,
                                  tmp_path, capsys):
    out = str(tmp_path / "s.pt2")
    argv = ["--amd_config", str(serving_files / "config.json"),
            "--amd_ckpt", str(serving_files / "amd.safetensors"),
            "--vae_ckpt", str(serving_files / "vae.safetensors"),
            "--out", out, "--frames", str(FRAMES), "--size", str(SIZE),
            "--sample_step", "1", "--device", "cpu", "--check"]
    export_sampler.main(argv)
    text = capsys.readouterr().out
    assert re.search(r"check OK: output \(5, 3, 32, 32\) torch.uint8, "
                     r"finite=True", text), text
    args = export_sampler.parse_args(argv)
    amd, vae = export_sampler.load_models(args, torch.device("cpu"))
    live = export_sampler.build_sampler(vae, amd, 1)
    inputs = export_sampler.example_inputs(amd, FRAMES, SIZE, "cpu")
    with torch.no_grad():
        got = torch.export.load(out).module()(*inputs)
        _same_uint8(got.numpy(), live(*inputs).numpy())
