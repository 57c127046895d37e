"""Int8 (w8a8) serving path (port of ``hivae_tpu/ops/quant.py``).

Scheme, as in the JAX package:

* **Weights**: per-output-channel symmetric int8, quantised once
  (:func:`quantize_params`), scale ``max(absmax, 1e-8) / 127``, round half
  to even, clip to +-127. The table also carries the float bias, so
  :func:`strip_quantized` can drop the float weight and bias of every
  covered layer from the serving model.
* **Activations**: dynamic per-token symmetric int8 for dense layers; one
  per-tensor scale for a convolution (a per-pixel scale does not factor out
  of a spatial convolution).
* **Coverage** (:func:`default_predicate`): dense layers with both dims
  >= 512 and convolutions with ``kh*kw*in >= 512`` and ``out >= 128``,
  except the AdaLN modulation ``linear`` and the timestep MLP
  ``linear_1/2``, which stay in the compute dtype.

Integration is PyTorch's: inside :func:`quantized_calls` every
``nn.Linear`` / ``nn.Conv2d`` named in the table runs its int8 counterpart
(its ``forward`` is replaced for the duration and restored on exit), and a
``FeedForward`` whose ``net.0.proj`` and ``net.2`` are both in the table
runs :func:`fused_quant_ffn`, the fused FFN-up + GELU + requantise kernel
(``ops/kernels/quant_ffn.py``), when ``supports(rows, K, N)`` holds.
Outside an aligned FFN the chain is the per-layer one and keeps the JAX
package's roundings: the up projection's output is cast to the compute
dtype before the GELU.

The int8 products outside the fused kernel (the attention projections, the
FFN-down, the convolutions) run on ``torch._int_mm`` (int8 x int8 -> int32,
cuBLASLt on the card), the int8 counterpart of a plain ``torch.matmul``;
each stays exact in int32. A convolution is one ``_int_mm`` per kernel tap
on shifted channels-last views of the padded int8 input, summed in int32:
a float convolution of the int8 values would not be exact (its sums reach
~7e7, past fp32's 2^24), and cuDNN has no int8 convolution in PyTorch.

Table layout: ``{module name: {"w8", "scale"[, "bias"]}}`` keyed by the
module's name under the model the table was built from. A dense ``w8`` is
(N, K) int8 (the ``nn.Linear`` weight layout, whose transpose is the
column-major operand ``_int_mm`` takes); a convolution's is (kh, kw, out,
in), one such (out, in) matrix per tap; ``scale`` is (N,) fp32, and so is
``bias`` (the layer's bias, cast once when the table is built, so no call
casts it).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .kernels import quant_ffn as qf

__all__ = ["quantize_params", "quantized_calls", "maybe_quantized",
           "quant_dense", "quant_conv", "quant_act", "fused_quant_ffn",
           "strip_quantized", "default_predicate"]

# Dense names never quantised regardless of size: AdaLN modulation
# ("linear"), timestep-embedding MLP ("linear_1/2").
_SKIP_NAMES = ("linear", "linear_1", "linear_2")

QuantTable = Dict[str, Dict[str, torch.Tensor]]


def default_predicate(name: str, weight: torch.Tensor,
                      min_dim: int = 512) -> bool:
    """The JAX package's predicate on a torch-layout weight: a dense (N, K)
    weight with both dims >= ``min_dim``; a conv (out, in, kh, kw) weight
    with ``kh*kw*in >= min_dim`` and ``out >= min_dim // 4``; never the
    modulation or timestep layers (by the last piece of ``name``)."""
    if name.split(".")[-1] in _SKIP_NAMES:
        return False
    if weight.dim() == 2:
        return min(weight.shape) >= min_dim
    if weight.dim() == 4:
        oc, ic, kh, kw = weight.shape
        return kh * kw * ic >= min_dim and oc >= max(min_dim // 4, 1)
    return False


def _quantize_kernel(weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, ...) torch-layout weight -> per-output-channel symmetric int8
    of the same shape + fp32 scale (out,)."""
    w32 = weight.detach().float()
    dims = tuple(range(1, w32.dim()))
    scale = qf.int8_scale(w32.abs().amax(dim=dims))
    col = scale.reshape((-1,) + (1,) * len(dims))
    w8 = torch.clamp(torch.round(w32 / col), -127, 127).to(torch.int8)
    return w8, scale


def _in_scope(name: str, scope: Optional[Tuple[str, ...]]) -> bool:
    return scope is None or tuple(name.split(".")[:len(scope)]) == tuple(scope)


@torch.no_grad()
def quantize_params(model: nn.Module, predicate: Optional[Callable] = None,
                    scope: Optional[Tuple[str, ...]] = (
                        "diffusion_transformer",)) -> QuantTable:
    """Build a quantisation table from ``model``'s ``nn.Linear`` and
    ``nn.Conv2d`` layers under ``scope`` (a prefix of module-name pieces;
    default the DiT, the only stack the sampler runs per Euler step;
    ``None`` for the whole model) that ``predicate(name, weight)`` selects
    (default :func:`default_predicate`). Raises when nothing matches."""
    pred = predicate or default_predicate
    table: QuantTable = {}
    for name, m in model.named_modules():
        if not isinstance(m, (nn.Linear, nn.Conv2d)) or not _in_scope(
                name, scope):
            continue
        if m.weight.numel() == 0:
            raise ValueError(f"{name} has no float weight (stripped?); "
                             "build the table before strip_quantized")
        if not pred(name, m.weight):
            continue
        w8, scale = _quantize_kernel(m.weight)
        if w8.dim() == 4:
            w8 = w8.permute(2, 3, 0, 1).contiguous()
        entry = {"w8": w8, "scale": scale}
        if m.bias is not None:
            entry["bias"] = m.bias.detach().float().contiguous()
        table[name] = entry
    if not table:
        raise ValueError(
            "quantize_params matched no kernels: wrong scope, or dims below "
            "the predicate's threshold")
    return table


def quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric dynamic int8: (..., K) -> ((..., K) int8,
    (..., 1) fp32 scales)."""
    return qf.requant_rows(x.float())


def quant_dense(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = dequant(quant(x) @ w8^T) + bias in x's dtype. ``x`` (..., K) any
    float dtype; ``w8`` (N, K) int8; ``scale`` (N,) fp32."""
    lead = x.shape[:-1]
    xq, sx = quant_act(x.reshape(-1, x.shape[-1]))
    y = qf.int8_mm(xq, w8).float() * (sx * scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(lead + (w8.shape[0],))


def fused_quant_ffn(x: torch.Tensor, up: Dict[str, torch.Tensor],
                    down: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The whole int8 FFN (up -> tanh-GELU -> down) with the intermediate
    activation quantised in the up product's epilogue
    (``kernels.quant_ffn.fused_ffn_up_quant``): the GELU stays fp32 and
    its (rows, inner) output is never materialised in a float dtype.
    ``up``/``down`` are table entries; ``x`` (..., K); the result is in x's
    dtype."""
    lead = x.shape[:-1]
    xq, sx = quant_act(x.reshape(-1, x.shape[-1]))
    b_up = up.get("bias")
    if b_up is None:   # a bias-free up projection (the model's have one)
        b_up = torch.zeros_like(up["scale"])
    yq, sy = qf.fused_ffn_up_quant(xq, sx, up["w8"], up["scale"], b_up)
    y = qf.int8_mm(yq, down["w8"]).float() * (sy * down["scale"])
    if "bias" in down:
        y = y + down["bias"].float()
    return y.to(x.dtype).reshape(lead + (down["w8"].shape[0],))


def _conv_pads(m: nn.Conv2d):
    """(stride (sh, sw), pads (top, bottom, left, right)) of ``m``, or None
    for what the int8 path does not reproduce (groups, dilation, a padding
    mode other than zeros, padding given by name)."""
    if (m.groups != 1 or tuple(m.dilation) != (1, 1)
            or m.padding_mode != "zeros" or isinstance(m.padding, str)):
        return None
    ph, pw = m.padding
    return tuple(m.stride), (ph, ph, pw, pw)


def int8_conv(xq: torch.Tensor, w8: torch.Tensor, stride=(1, 1),
              pads=(0, 0, 0, 0)) -> torch.Tensor:
    """Exact int32 convolution of int8 ``xq`` (N, C, H, W) with ``w8``
    (kh, kw, out, C), zero ``pads`` (top, bottom, left, right) -> (N, Ho,
    Wo, out): one int8 product per kernel tap on a shifted channels-last
    view of the padded input, summed in int32."""
    top, bottom, left, right = pads
    xq = F.pad(xq.permute(0, 2, 3, 1), (0, 0, left, right, top, bottom))
    n, hp, wp, c = xq.shape
    kh, kw, oc, _ = w8.shape
    sh, sw = stride
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xq[:, i:i + sh * (ho - 1) + 1:sh,
                     j:j + sw * (wo - 1) + 1:sw].reshape(-1, c)
            part = qf.int8_mm(tap, w8[i, j])
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(n, ho, wo, oc)


def quant_conv(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *, stride=(1, 1),
               pads=(0, 0, 0, 0)) -> torch.Tensor:
    """y = dequant(quant(x) conv w8) + bias in x's dtype, the product exact
    in int32.
    ``x`` (N, C, H, W) any float dtype; ``w8`` (kh, kw, out, C) int8;
    ``scale`` (out,) fp32; ``pads`` (top, bottom, left, right) zeros. One
    per-tensor activation scale. Returns (N, out, Ho, Wo), channels-last in
    memory."""
    xf = x.float()
    sx = qf.int8_scale(xf.abs().amax())
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = int8_conv(xq, w8, stride, pads).float() * (sx * scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).permute(0, 3, 1, 2)


def _dense_forward(entry, x):
    return quant_dense(x, entry["w8"], entry["scale"], entry.get("bias"))


def _conv_forward(entry, geometry, x):
    return quant_conv(x, entry["w8"], entry["scale"], entry.get("bias"),
                      stride=geometry[0], pads=geometry[1])


def _ffn_forward(module, up, down, x):
    rows = x.numel() // x.shape[-1]
    n, k = up["w8"].shape
    if qf.supports(rows, k, n):
        return fused_quant_ffn(x, up, down)
    # unsupported geometry: the class's own chain, whose two linears run
    # their int8 forward
    return type(module).forward(module, x)


def _stripped_forward(name, *args, **kwargs):
    raise RuntimeError(f"{name}: its float weight was stripped "
                       "(strip_quantized); call it inside quantized_calls "
                       "with its table")


_NO_FORWARD = object()


@contextlib.contextmanager
def quantized_calls(model: nn.Module, quant_table: QuantTable,
                    fuse_ffn: bool = True):
    """Context manager: inside, every layer of ``model`` named in
    ``quant_table`` runs its int8 kernel instead of its float one, and
    every ``FeedForward`` with both linears in the table runs
    :func:`fused_quant_ffn` where the geometry allows (``fuse_ffn=False``
    keeps the per-layer chain). Each module's ``forward`` is restored on
    exit. A table entry that names no ``nn.Linear`` / ``nn.Conv2d``, or a
    conv whose geometry the int8 path does not reproduce, raises."""
    from ..models.blocks import FeedForward  # models import ops

    patched = []

    def patch(m, fn):
        patched.append((m, m.__dict__.get("forward", _NO_FORWARD)))
        m.forward = fn

    try:
        for name, entry in quant_table.items():
            m = model.get_submodule(name)
            if isinstance(m, nn.Linear):
                patch(m, functools.partial(_dense_forward, entry))
            elif isinstance(m, nn.Conv2d):
                geometry = _conv_pads(m)
                if geometry is None:
                    # serving it in float would read a weight that
                    # strip_quantized may have dropped: fail loudly
                    raise NotImplementedError(
                        f"quantized conv {name} uses a geometry the int8 "
                        "path does not reproduce (grouped/dilated/padding "
                        "mode); exclude it from the quantization predicate")
                patch(m, functools.partial(_conv_forward, entry, geometry))
            else:
                raise TypeError(f"{name}: a {type(m).__name__}, not an "
                                "nn.Linear or nn.Conv2d")
        if fuse_ffn:
            for name, m in model.named_modules():
                if not isinstance(m, FeedForward):
                    continue
                prefix = f"{name}." if name else ""
                up = quant_table.get(prefix + "net.0.proj")
                down = quant_table.get(prefix + "net.2")
                if up is not None and down is not None:
                    patch(m, functools.partial(_ffn_forward, m, up, down))
        yield
    finally:
        for m, prev in reversed(patched):
            if prev is _NO_FORWARD:
                del m.forward
            else:
                m.forward = prev


def maybe_quantized(model: nn.Module, quant_table: Optional[QuantTable]):
    """``quantized_calls(model, table)`` when a table is given, else a null
    context, so call sites keep one code path."""
    if quant_table:
        return quantized_calls(model, quant_table)
    return contextlib.nullcontext()


def _emptied(p: torch.Tensor) -> nn.Parameter:
    """An empty parameter of ``p``'s dtype and device: the float data goes,
    what code reads of the layer (its dtype, its device) stays."""
    return nn.Parameter(torch.empty((0,), dtype=p.dtype, device=p.device),
                        requires_grad=False)


def strip_quantized(model: nn.Module, quant_table: QuantTable) -> nn.Module:
    """Drop the float weight (and the bias the table carries a copy of) of
    every quantised layer of ``model``, in place: each becomes an empty
    tensor of its dtype, so the serving model holds int8 and scales in the
    table and floats for everything else. A stripped layer called outside
    :func:`quantized_calls` raises instead of serving from anything else.
    Returns ``model``."""
    for name, entry in quant_table.items():
        m = model.get_submodule(name)
        m.weight = _emptied(m.weight)
        if "bias" in entry:
            m.bias = _emptied(m.bias)
        m.forward = functools.partial(_stripped_forward, name)
    return model
