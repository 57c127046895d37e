"""JAX parameter tree -> the port's PyTorch ``state_dict``.

The port's modules carry the reference's diffusers parameter names (the
same names ``hivae_tpu/utils/torch_convert.py`` maps flax paths onto), so
one name map serves both the JAX checkpoints and the reference's torch
ones. Layouts:

  * Dense kernel (in, out)   -> Linear weight (out, in)   [transpose]
  * Conv kernel  (kh,kw,I,O) -> Conv2d weight (O,I,kh,kw)
  * Conv kernel  (kd,kh,kw,I,O) -> Conv3d weight (O,I,kd,kh,kw)
  * LayerNorm/GroupNorm/BatchNorm ``scale`` -> ``weight``
  * ``batch_stats`` ``mean``/``var`` -> BatchNorm ``running_mean``/
    ``running_var`` buffers
  * raw parameters (``label_embedding``, ``motion_align_c``/``_o``,
    ``cls_token``, ``mask_token``, ...) as they are
  * the ``nn.scan``-stacked ``layers/{object,camera,spatial}_block`` tree
    (``scan_layers=True``, leading dim L) -> per-layer ModuleList entries,
    for both velocity DiTs (the TempMotion DiT stacks ``object_block``
    only). This is the port's counterpart of the JAX package's
    ``hivae_tpu/ops/quant.py::unstack_scanned``: a scanned tree bridges
    to the same state dict as ``unstack_scanned`` of it, which a
    ``scan_layers=False`` model loads (``test_torch_longtail_models.py``
    holds the two equal), so there is no second copy of it here.

The modules of the config flags carry the JAX names too
(``camera_down/conv{1,2}``, ``motion_transformer/{embed,blocks_i,
norm_final,proj_out}``), so the same rules cover them, and so do the A2M
heads' (``audio_encoder/{ff1,ff2,ff3,norm}`` or ``audio_encoder/mlp/{fc1,
fc2}``, ``diffusion/{motion,audio,pose}_blocks_i`` or ``diffusion/
blocks_i``, ``pose_predictor/{temporal_spatial,audio}_blocks_i`` and its
``pose_mask_token``, the embeddings (a ``PatchEmbed``'s ``proj`` keeps
its channel-major patch layout), ``norm_final``, ``norm_out``,
``proj_out``), and the other models' (T2M's ``motion_blocks_i`` and
``image_blocks_i``, the MAE's ``blocks_i`` and ``decoder_blocks_i``, the
CNN motion AE's ``downblock_i``, ``upblock_i`` and ``map_i``, the
discriminators' ``conv_i``/``norm_i``), and the blocks and DiTs no model
builds (``Any2MotionBlock``'s and ``RefMotionRefImageBlock``'s
``norm1``-``norm4`` and ``attn1``-``attn3``, ``MotionTransferBlock``,
``AudioToImageShapeMlp``'s ``mlp/{fc1,fc2}``, ``VelocityDiTSplitInput``'s
``{motion,zi,zt}_patch_embed`` and ``DiT2Condition``'s
``{image,refimg,motion}_patch_embed`` with their ``blocks_i``): their
names need no rule beyond these.

Input is the flax tree as nested mappings of numpy arrays (with or without
the top-level ``params`` collection). ``lpips_flax_to_torch`` maps the
JAX ``LPIPS`` tree (``net/features_<i>``, Dense heads ``lin<k>``) onto the
port's ``losses.lpips.LPIPS``; ``flax_quant_table_to_torch`` carries a JAX
int8 quantisation table (``hivae_tpu/ops/quant.py::quantize_params``) over
to the port's table (``ops/quant.py``).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch

# flax path piece -> torch name piece (applied to the joined dotted name)
_RULES: List[Tuple[str, str]] = [
    (r"\bblocks_(\d+)\b", r"transformer_blocks.\1"),
    (r"\bobject_blocks_(\d+)\b", r"object_transformer_blocks.\1"),
    (r"\bcamera_blocks_(\d+)\b", r"camera_transformer_blocks.\1"),
    (r"\bspatial_blocks_(\d+)\b", r"spatial_blocks.\1"),
    (r"\bmotion_blocks_(\d+)\b", r"motion_blocks.\1"),
    (r"\baudio_blocks_(\d+)\b", r"audio_blocks.\1"),
    (r"\bpose_blocks_(\d+)\b", r"pose_blocks.\1"),
    # `_` is a word character: \bspatial_blocks_ does not match in here
    (r"\btemporal_spatial_blocks_(\d+)\b", r"temporal_spatial_blocks.\1"),
    (r"\bresnets_(\d+)\b", r"resnets.\1"),
    (r"\battentions_(\d+)\b", r"attentions.\1"),
    (r"\bdownsamplers_(\d+)\b", r"downsamplers.\1"),
    (r"\bupsamplers_(\d+)\b", r"upsamplers.\1"),
    (r"\bdown_blocks_(\d+)\b", r"down_blocks.\1"),
    (r"\bup_blocks_(\d+)\b", r"up_blocks.\1"),
    (r"\bdownblock_(\d+)\b", r"downblock.\1"),
    (r"\bupblock_(\d+)\b", r"upblock.\1"),
    (r"\bmap_(\d+)\b", r"map.\1"),
    (r"\bimage_blocks_(\d+)\b", r"image_blocks.\1"),
    (r"\bdecoder_blocks_(\d+)\b", r"decoder_blocks.\1"),
    (r"\bnet_0\b", "net.0.proj"),
    (r"\bnet_2\b", "net.2"),
    (r"\bto_out\b", "to_out.0"),
    (r"\bfeatures_(\d+)\b", r"features.\1"),
]

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}

# nn.scan stack member -> the unrolled per-layer name it stands for
_SCAN_BLOCK_NAMES = {
    "object_block": "object_blocks",
    "camera_block": "camera_blocks",
    "spatial_block": "spatial_blocks",
}


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """('encoder','down_blocks_0','resnets_1','conv1','kernel') ->
    'encoder.down_blocks.0.resnets.1.conv1.weight'."""
    *mods, leaf = path
    name = ".".join(mods)
    for pat, rep in _RULES:
        name = re.sub(pat, rep, name)
    leaf_name = _LEAF.get(leaf, leaf)
    return f"{name}.{leaf_name}" if name else leaf_name


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for name, val in tree.items():
        path = prefix + (str(name),)
        if isinstance(val, Mapping):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def _unstack(path: Tuple[str, ...], arr: np.ndarray):
    """Split a scanned (L, ...) leaf into per-layer (path, array) pairs."""
    if "layers" in path:
        i = path.index("layers")
        if i + 1 < len(path) and path[i + 1] in _SCAN_BLOCK_NAMES:
            block = _SCAN_BLOCK_NAMES[path[i + 1]]
            for layer in range(arr.shape[0]):
                yield (path[:i] + (f"{block}_{layer}",) + path[i + 2:],
                       arr[layer])
            return
    yield path, arr


def _torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel":
        if arr.ndim == 2:
            return arr.T
        if arr.ndim == 4:
            return arr.transpose(3, 2, 0, 1)
        if arr.ndim == 5:
            return arr.transpose(4, 3, 0, 1, 2)
        raise ValueError(f"unexpected kernel rank {arr.ndim}")
    return arr


# flax ``batch_stats`` leaf -> the BatchNorm buffer it fills
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def _leaves(params: Mapping[str, Any]):
    """(path, array) of every parameter leaf, and of every ``batch_stats``
    leaf under its buffer's name, of a tree with or without its
    collections."""
    if "params" in params and set(params) <= {"params", "batch_stats"}:
        yield from _flatten(params["params"])
        for path, arr in _flatten(params.get("batch_stats", {})):
            yield path[:-1] + (_STATS_LEAF[path[-1]],), arr
        return
    yield from _flatten(params)


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax variables (``params``, optionally ``batch_stats``, or a bare
    parameter tree) -> state dict for the port's matching module."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(params):
        for p, a in _unstack(path, arr):
            key = flax_path_to_torch_key(p)
            if key in out:
                raise ValueError(f"two flax leaves map onto {key}")
            out[key] = torch.from_numpy(
                np.array(_torch_layout(p[-1], a), order="C", copy=True))
    return out


def lpips_flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS`` tree -> state dict of the port's ``LPIPS``: the Dense
    heads (C, 1) become 1x1 conv weights (1, C, 1, 1)."""
    out = flax_to_torch(params)
    for k in range(5):
        key = f"lin{k}.weight"
        out[key] = out[key].reshape(1, -1, 1, 1).contiguous()
    return out


def flax_quant_table_to_torch(table: Mapping[str, Mapping[str, Any]]
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX quantisation table (keys ``"a/b/to_q"``, ``w8`` (K, N) or HWIO
    int8, ``scale`` (N,), optional ``bias``) -> the port's table: keys are
    the port's module names (the flax path mapped as a ``kernel`` leaf),
    a dense ``w8`` becomes (N, K) and a conv's (kh, kw, out, in), and the
    bias is fp32, as ``ops.quant.quantize_params`` stores it."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for path, entry in table.items():
        key = flax_path_to_torch_key(tuple(path.split("/")) + ("kernel",))
        w8 = np.asarray(entry["w8"])
        w8 = w8.T if w8.ndim == 2 else w8.transpose(0, 1, 3, 2)
        converted = {"w8": w8, "scale": np.asarray(entry["scale"])}
        if "bias" in entry:
            converted["bias"] = np.asarray(entry["bias"], np.float32)
        out[key[:-len(".weight")]] = {
            k: torch.from_numpy(np.array(v, order="C", copy=True))
            for k, v in converted.items()}
    return out
