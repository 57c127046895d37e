"""Transformer blocks of the clip-reconstruction path and of the A2M
heads, with their audio feature MLPs (port of
``hivae_tpu/models/blocks.py``).

Parameter names follow the reference's diffusers modules (``to_out.0``,
``net.0.proj``, ``net.2``), which ``utils/params.py`` maps the JAX trees
onto. Attention runs through ``ops.attention.sdpa`` on (B, H, S, D)
tensors, so long sequences reach the hand-written kernels.

``Attention``, ``FeedForward`` and ``Mlp`` split their weights over the
mesh's ``tensor`` axis when ``parallel/tensor_parallel.py::shard_tensor``
gives them ``.tp``: the column layers compute this rank's heads or hidden
slice, the row layer sums the partial products over the group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attn_ops
from ..ops import embeddings as emb_ops


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, S, H * head_dim) -> (B, H, S, head_dim); H is read from the
    width, so a rank's slice of the heads splits as the whole does."""
    b, s, _ = x.shape
    return x.view(b, s, -1, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def modulate(x: torch.Tensor, scale: torch.Tensor,
             shift: torch.Tensor) -> torch.Tensor:
    """AdaLN modulation ``x * (1 + scale) + shift``."""
    return x * (1.0 + scale) + shift


class Attention(nn.Module):
    """Multi-head attention with diffusers ``Attention`` semantics; the
    optional per-head q/k LayerNorm (eps 1e-6) is applied inside ``sdpa``,
    ``norm_q``/``norm_k`` only hold its parameters."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qk_norm: bool = True, qkv_bias: bool = True,
                 out_bias: bool = True, eps: float = 1e-6):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.eps, self.qk_norm = heads, eps, qk_norm
        self.head_dim = head_dim
        self.tp = None     # weight tensor parallelism (shard_tensor)
        self.to_q = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(dim, inner, bias=qkv_bias)
        if qk_norm:
            self.norm_q = nn.LayerNorm(head_dim, eps=eps)
            self.norm_k = nn.LayerNorm(head_dim, eps=eps)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim, bias=out_bias)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qk = None
        if self.qk_norm:
            qk = (self.norm_q.weight, self.norm_q.bias,
                  self.norm_k.weight, self.norm_k.bias)
        if self.tp is not None:
            return self._forward_tp(x, context, key_mask, qk)
        ctx = x if context is None else context
        q = _split_heads(self.to_q(x), self.head_dim)
        k = _split_heads(self.to_k(ctx), self.head_dim)
        v = _split_heads(self.to_v(ctx), self.head_dim)
        out = attn_ops.sdpa(q, k, v, key_mask=key_mask, qk_norm=qk,
                            qk_norm_eps=self.eps)
        return self.to_out[0](_merge_heads(out))

    def _forward_tp(self, x, context, key_mask, qk):
        """This rank's heads: q/k/v column parallel (their biases and the
        per-head q/k norm whole, entered with the inputs), the output row
        parallel."""
        tp, lins = self.tp, (self.to_q, self.to_k, self.to_v)
        x, context, *rest = tp.enter(x, context, *[l.bias for l in lins],
                                     *(qk or ()))
        ctx = x if context is None else context
        q, k, v = (_split_heads(tp.column(lin, y, tp.part(b)),
                                self.head_dim)
                   for lin, y, b in zip(lins, (x, ctx, ctx), rest))
        out = attn_ops.sdpa(q, k, v, key_mask=key_mask,
                            qk_norm=tuple(rest[3:]) or None,
                            qk_norm_eps=self.eps)
        return tp.row(self.to_out[0], _merge_heads(out))


class _GELUProj(nn.Module):
    """diffusers ``GELU(approximate='tanh')``: projection then tanh-GELU."""

    def __init__(self, dim: int, inner: int, bias: bool):
        super().__init__()
        self.proj = nn.Linear(dim, inner, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """MLP with tanh-approximate GELU; ``net.1`` is diffusers' dropout
    slot, kept so the parameter names match. The output is ``dim`` wide
    unless ``out_dim`` is given."""

    def __init__(self, dim: int, inner_dim: Optional[int] = None,
                 use_bias: bool = True, out_dim: Optional[int] = None):
        super().__init__()
        inner = inner_dim or 4 * dim
        self.net = nn.ModuleList([_GELUProj(dim, inner, use_bias),
                                  nn.Identity(),
                                  nn.Linear(inner, out_dim or dim,
                                            bias=use_bias)])
        self.tp = None     # weight tensor parallelism (shard_tensor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:   # this rank's slice of the hidden width
            proj = self.net[0].proj
            x, b = self.tp.enter(x, proj.bias)
            h = F.gelu(self.tp.column(proj, x, self.tp.part(b)),
                       approximate="tanh")
            return self.tp.row(self.net[2], h)
        for layer in self.net:
            x = layer(x)
        return x


class TimestepEmbedding(nn.Module):
    """Sinusoid (flip_sin_to_cos, shift 0) + 2-layer SiLU MLP."""

    def __init__(self, sinusoid_dim: int, time_embed_dim: int):
        super().__init__()
        self.sinusoid_dim = sinusoid_dim
        self.linear_1 = nn.Linear(sinusoid_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = emb_ops.timestep_embedding(timesteps, self.sinusoid_dim)
        emb = self.linear_1(emb.to(self.linear_1.weight.dtype))
        return self.linear_2(F.silu(emb))


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as reshape + matmul: (N, C, H, W) ->
    (N, H/p * W/p, embed_dim), channel-major patch layout."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 use_bias: bool = True):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Linear(in_channels * patch_size ** 2, embed_dim,
                              bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        p = self.patch_size
        x = x.reshape(n, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(n, (h // p) * (w // p), c * p * p)
        return self.proj(x.to(self.proj.weight.dtype))


class AdaLNZero(nn.Module):
    """Joint two-stream AdaLN-Zero: one linear -> 6 chunks, one shared
    affine LayerNorm for both streams."""

    def __init__(self, embed_dim: int, cond_dim: int):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 6 * embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, hidden, encoder, temb):
        (shift, scale, gate, e_shift, e_scale,
         e_gate) = self.linear(F.silu(temb)).chunk(6, dim=-1)
        hidden = modulate(self.norm(hidden), scale[:, None], shift[:, None])
        encoder = modulate(self.norm(encoder), e_scale[:, None],
                           e_shift[:, None])
        return hidden, encoder, gate[:, None], e_gate[:, None]


class AdaLNZeroSingle(nn.Module):
    """One-stream AdaLN-Zero: linear -> (shift, scale, gate)."""

    def __init__(self, embed_dim: int, cond_dim: int):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 3 * embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, hidden, temb):
        shift, scale, gate = self.linear(F.silu(temb)).chunk(3, dim=-1)
        return (modulate(self.norm(hidden), scale[:, None], shift[:, None]),
                gate[:, None])


class AdaLNZeroTriple(nn.Module):
    """Three-stream AdaLN-Zero: one linear -> 9 chunks (shift, scale, gate
    of the hidden stream, then of each condition), one shared affine
    LayerNorm."""

    def __init__(self, embed_dim: int, cond_dim: int):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 9 * embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, hidden, cond1, cond2, temb):
        (shift, scale, gate, c1_shift, c1_scale, c1_gate, c2_shift, c2_scale,
         c2_gate) = self.linear(F.silu(temb)).chunk(9, dim=-1)
        hidden = modulate(self.norm(hidden), scale[:, None], shift[:, None])
        cond1 = modulate(self.norm(cond1), c1_scale[:, None],
                         c1_shift[:, None])
        cond2 = modulate(self.norm(cond2), c2_scale[:, None],
                         c2_shift[:, None])
        return (hidden, cond1, cond2, gate[:, None], c1_gate[:, None],
                c2_gate[:, None])


class AdaLayerNorm(nn.Module):
    """Shift/scale AdaLN of the DiT output head."""

    def __init__(self, embed_dim: int, cond_dim: int):
        super().__init__()
        self.linear = nn.Linear(cond_dim, 2 * embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return modulate(self.norm(x), scale[:, None], shift[:, None])


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention block."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, key_mask=None):
        x = x + self.attn1(self.norm1(x), key_mask=key_mask)
        return x + self.ff(self.norm2(x))


class BasicCrossTransformerBlock(nn.Module):
    """Pre-LN cross-attention block: Q from ``x``, K/V from ``context``."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x), context)
        return x + self.ff(self.norm2(x))


class JointTransformerBlock(nn.Module):
    """Two-stream joint block: AdaLN-Zero both streams, self-attend over
    [encoder, hidden], gated residuals, the same for the FF. Returns
    (hidden, encoder)."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZero(dim, cond_dim)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = AdaLNZero(dim, cond_dim)
        self.ff = FeedForward(dim)

    def forward(self, hidden, encoder, temb, hidden_key_mask=None):
        enc_len = encoder.shape[1]
        mask = None
        if hidden_key_mask is not None:
            # joint order is [encoder, hidden]; only hidden tokens are masked
            mask = torch.cat([torch.ones(encoder.shape[:2], dtype=torch.bool,
                                         device=encoder.device),
                              hidden_key_mask], dim=1)
        h, e, gate, e_gate = self.norm1(hidden, encoder, temb)
        out = self.attn1(torch.cat([e, h], dim=1), key_mask=mask)
        hidden = hidden + gate * out[:, enc_len:]
        encoder = encoder + e_gate * out[:, :enc_len]

        h, e, gate, e_gate = self.norm2(hidden, encoder, temb)
        out = self.ff(torch.cat([e, h], dim=1))
        hidden = hidden + gate * out[:, enc_len:]
        encoder = encoder + e_gate * out[:, :enc_len]
        return hidden, encoder


class DiTBlock(nn.Module):
    """Single-stream AdaLN-Zero DiT block."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZeroSingle(dim, cond_dim)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = AdaLNZeroSingle(dim, cond_dim)
        self.ff = FeedForward(dim)

    def forward(self, x, temb):
        h, gate = self.norm1(x, temb)
        x = x + gate * self.attn1(h)
        h, gate = self.norm2(x, temb)
        return x + gate * self.ff(h)


class MotionTemporalBlock(nn.Module):
    """Self-attention block over a temporal motion axis: AdaLN-Zero
    conditioned on ``temb`` with ``use_adaln`` (``cond_dim`` its width),
    else a pre-LN block whose gates are the constant 1."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 use_adaln: bool = False, cond_dim: Optional[int] = None,
                 qkv_bias: bool = True):
        super().__init__()
        self.use_adaln = use_adaln
        if use_adaln:
            self.norm1 = AdaLNZeroSingle(dim, cond_dim)
            self.norm2 = AdaLNZeroSingle(dim, cond_dim)
        else:
            self.norm1 = nn.LayerNorm(dim, eps=1e-5)
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.ff = FeedForward(dim)

    def forward(self, x, temb=None):
        if self.use_adaln:
            h, gate = self.norm1(x, temb)
            x = x + gate * self.attn1(h)
            h, gate = self.norm2(x, temb)
            return x + gate * self.ff(h)
        x = x + self.attn1(self.norm1(x))
        return x + self.ff(self.norm2(x))


class A2MMotionSelfAttnBlock(nn.Module):
    """A2M joint self-attention over [ref_motion; motion] with two-stream
    AdaLN-Zero (qk-norm on). Streams: motion (N, F*L, D), ref (N, L, D).
    Returns (motion, ref_motion)."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZero(dim, cond_dim)
        self.attn = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = AdaLNZero(dim, cond_dim)
        self.ff = FeedForward(dim)

    def forward(self, motion, ref_motion, temb):
        l = ref_motion.shape[1]
        m, r, gate, r_gate = self.norm1(motion, ref_motion, temb)
        out = self.attn(torch.cat([r, m], dim=1))
        motion = motion + gate * out[:, l:]
        ref_motion = ref_motion + r_gate * out[:, :l]

        m, r, gate, r_gate = self.norm2(motion, ref_motion, temb)
        out = self.ff(torch.cat([r, m], dim=1))
        motion = motion + gate * out[:, l:]
        ref_motion = ref_motion + r_gate * out[:, :l]
        return motion, ref_motion


class A2MCrossAttnBlock(nn.Module):
    """Per-frame cross-attention of the A2M head: motion (N, F*L, D) and
    ref (N, L, D) are re-batched to (N*(F+1), L, D) frames, each attending
    to its own condition window ((N, F+1, W, D) or (N*(F+1), W, D)); no
    qk-norm on the cross-attention. Returns (motion, ref_motion)."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZero(dim, cond_dim)
        self.attn = Attention(dim, heads, head_dim, qk_norm=False,
                              qkv_bias=qkv_bias)
        self.norm2 = AdaLNZero(dim, cond_dim)
        self.ff = FeedForward(dim)

    def forward(self, motion, ref_motion, condition, temb):
        n, fl, d = motion.shape
        l = ref_motion.shape[1]
        f1 = fl // l + 1  # frames + the reference
        if condition.dim() == 4:
            condition = condition.reshape((-1,) + condition.shape[2:])
        m, r, gate, r_gate = self.norm1(motion, ref_motion, temb)
        joint = torch.cat([r, m], dim=1).reshape(n * f1, l, d)
        out = self.attn(joint, condition).reshape(n, f1 * l, d)
        motion = motion + gate * out[:, l:]
        ref_motion = ref_motion + r_gate * out[:, :l]

        m, r, gate, r_gate = self.norm2(motion, ref_motion, temb)
        out = self.ff(torch.cat([r, m], dim=1))
        motion = motion + gate * out[:, l:]
        ref_motion = ref_motion + r_gate * out[:, :l]
        return motion, ref_motion


class Any2MotionBlock(nn.Module):
    """Motion denoiser block with a 3-D self-attention and two
    cross-attentions (the reference's ``Any2MotionTransformerBlock``). x is
    (B*F, L, D); the self-attention runs over each clip's flattened F*L
    tokens, the cross-attentions (to ``refimg`` and ``extra``, no qk-norm)
    frame by frame. No model of the repository builds it."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 motion_frames: int, qkv_bias: bool = True):
        super().__init__()
        self.motion_frames = motion_frames
        for i in range(1, 5):
            setattr(self, f"norm{i}", AdaLayerNorm(dim, cond_dim))
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.attn2 = Attention(dim, heads, head_dim, qk_norm=False,
                               qkv_bias=qkv_bias)
        self.attn3 = Attention(dim, heads, head_dim, qk_norm=False,
                               qkv_bias=qkv_bias)
        self.ff = FeedForward(dim)

    def forward(self, x, refimg, extra, temb):
        bf, l, d = x.shape
        f = self.motion_frames
        x = self.norm1(x, temb)
        x3d = x.reshape(bf // f, f * l, d)
        x = (x3d + self.attn1(x3d)).reshape(bf, l, d)
        x = self.norm2(x, temb)
        x = x + self.attn2(x, refimg)
        x = self.norm3(x, temb)
        x = x + self.attn3(x, extra)
        x = self.norm4(x, temb)
        return x + self.ff(x)


class RefMotionRefImageBlock(nn.Module):
    """Self-attention, then cross-attention to the reference motion and to
    the reference image (no qk-norm on either), each behind a shift/scale
    AdaLN (the reference's ``RefMotionRefImgeBlock``). No model of the
    repository builds it."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"norm{i}", AdaLayerNorm(dim, cond_dim))
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.attn2 = Attention(dim, heads, head_dim, qk_norm=False,
                               qkv_bias=qkv_bias)
        self.attn3 = Attention(dim, heads, head_dim, qk_norm=False,
                               qkv_bias=qkv_bias)
        self.ff = FeedForward(dim)

    def forward(self, x, refmotion, refimg, temb):
        x = self.norm1(x, temb)
        x = x + self.attn1(x)
        x = self.norm2(x, temb)
        x = x + self.attn2(x, refmotion)
        x = self.norm3(x, temb)
        x = x + self.attn3(x, refimg)
        x = self.norm4(x, temb)
        return x + self.ff(x)


class MotionTransferBlock(nn.Module):
    """Two-stream joint block with the hidden stream first in the
    attention's concatenation and, as the reference's
    ``MotionTrensferBlock`` does, the encoder stream first in the
    feed-forward's (its outputs are then split at the hidden stream's
    length all the same). Returns (hidden, encoder). No model of the
    repository builds it."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZero(dim, cond_dim)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = AdaLNZero(dim, cond_dim)
        self.ff = FeedForward(dim)

    def forward(self, hidden, encoder, temb):
        ml = hidden.shape[1]
        h, e, gate, e_gate = self.norm1(hidden, encoder, temb)
        out = self.attn1(torch.cat([h, e], dim=1))
        hidden = hidden + gate * out[:, :ml]
        encoder = encoder + e_gate * out[:, ml:]
        h, e, gate, e_gate = self.norm2(hidden, encoder, temb)
        out = self.ff(torch.cat([e, h], dim=1))
        hidden = hidden + gate * out[:, :ml]
        encoder = encoder + e_gate * out[:, ml:]
        return hidden, encoder


def _split3(out, hl: int, c1l: int):
    return out[:, :hl], out[:, hl:hl + c1l], out[:, hl + c1l:]


class JointBlock2Condition(nn.Module):
    """Three-stream joint block: 9-way AdaLN-Zero, self-attention over
    [hidden, cond1, cond2], per-stream gated residuals, the same for the
    FF. Returns (hidden, cond1, cond2)."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZeroTriple(dim, cond_dim)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = AdaLNZeroTriple(dim, cond_dim)
        self.ff = FeedForward(dim)

    def forward(self, hidden, cond1, cond2, temb):
        hl, c1l = hidden.shape[1], cond1.shape[1]
        h, c1, c2, g, g1, g2 = self.norm1(hidden, cond1, cond2, temb)
        o, o1, o2 = _split3(self.attn1(torch.cat([h, c1, c2], dim=1)), hl,
                            c1l)
        hidden, cond1, cond2 = hidden + g * o, cond1 + g1 * o1, \
            cond2 + g2 * o2
        h, c1, c2, g, g1, g2 = self.norm2(hidden, cond1, cond2, temb)
        o, o1, o2 = _split3(self.ff(torch.cat([h, c1, c2], dim=1)), hl, c1l)
        return hidden + g * o, cond1 + g1 * o1, cond2 + g2 * o2


class JointBlock2ConditionSimple(nn.Module):
    """Three-stream joint block with AdaLN-Zero on the hidden stream only;
    the conditions take a plain pre-LN and ungated residuals."""

    def __init__(self, dim: int, heads: int, head_dim: int, cond_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = AdaLNZeroSingle(dim, cond_dim)
        self.norm1_condition1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm1_condition2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = AdaLNZeroSingle(dim, cond_dim)
        self.norm2_condition1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2_condition2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, hidden, cond1, cond2, temb):
        hl, c1l = hidden.shape[1], cond1.shape[1]
        h, gate = self.norm1(hidden, temb)
        joint = torch.cat([h, self.norm1_condition1(cond1),
                           self.norm1_condition2(cond2)], dim=1)
        o, o1, o2 = _split3(self.attn1(joint), hl, c1l)
        hidden, cond1, cond2 = hidden + gate * o, cond1 + o1, cond2 + o2
        h, gate = self.norm2(hidden, temb)
        joint = torch.cat([h, self.norm2_condition1(cond1),
                           self.norm2_condition2(cond2)], dim=1)
        o, o1, o2 = _split3(self.ff(joint), hl, c1l)
        return hidden + gate * o, cond1 + o1, cond2 + o2


class A2PTemporalSpatialBlock(nn.Module):
    """Pre-LN attention over time (each token's F frames), then over space
    (each frame's L tokens), then the FF; (N, F, L, D) in and out."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, f, l, d = x.shape
        xt = x.transpose(1, 2).reshape(n * l, f, d)
        xt = xt + self.attn1(self.norm1(xt))
        xs = xt.reshape(n, l, f, d).transpose(1, 2).reshape(n * f, l, d)
        xs = xs + self.attn2(self.norm2(xs))
        xs = xs + self.ff(self.norm3(xs))
        return xs.reshape(n, f, l, d)


class A2PCrossAudioBlock(nn.Module):
    """Per-frame pre-LN cross-attention of the pose tokens (N, F, L, D) to
    the frame's audio window (N, F, W, D), then the FF."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        n, f, l, d = x.shape
        xf = x.reshape(n * f, l, d)
        xf = xf + self.attn1(self.norm1(xf),
                             audio.reshape(n * f, audio.shape[2], d))
        xf = xf + self.ff(self.norm2(xf))
        return xf.reshape(n, f, l, d)


class Mlp(nn.Module):
    """timm-style MLP: fc1, exact (erf) GELU, fc2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features)
        self.tp = None     # weight tensor parallelism (shard_tensor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:   # this rank's slice of the hidden width
            x, b = self.tp.enter(x, self.fc1.bias)
            h = F.gelu(self.tp.column(self.fc1, x, self.tp.part(b)))
            return self.tp.row(self.fc2, h)
        return self.fc2(F.gelu(self.fc1(x)))


class AudioFeatureMlp(nn.Module):
    """(N, F, M, C) audio features -> (N, F, outdim): each frame's
    flattened (M*C) features through an ``Mlp`` of width ``outdim``."""

    def __init__(self, in_features: int, outdim: int):
        super().__init__()
        self.mlp = Mlp(in_features, outdim, outdim)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        n, f = audio.shape[:2]
        return self.mlp(audio.reshape(n, f, -1).to(self.mlp.fc1.weight.dtype))


class AudioFeatureWindowMlp(nn.Module):
    """(N, F, M, C) audio features -> (N, F, window, outdim): three ReLU
    linears on each frame's flattened (M*C) features, a reshape to the
    window, then a LayerNorm (eps 1e-5)."""

    def __init__(self, in_features: int, intermediate_dim: int,
                 window_size: int, outdim: int):
        super().__init__()
        self.window_size, self.outdim = window_size, outdim
        self.ff1 = nn.Linear(in_features, intermediate_dim)
        self.ff2 = nn.Linear(intermediate_dim, intermediate_dim)
        self.ff3 = nn.Linear(intermediate_dim, window_size * outdim)
        self.norm = nn.LayerNorm(outdim, eps=1e-5)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        n, f = audio.shape[:2]
        x = audio.reshape(n, f, -1).to(self.ff1.weight.dtype)
        x = F.relu(self.ff1(x))
        x = F.relu(self.ff2(x))
        x = F.relu(self.ff3(x))
        return self.norm(x.reshape(n, f, self.window_size, self.outdim))


class AudioToImageShapeMlp(nn.Module):
    """(N, F, M, C) audio features -> (N, F, outchannel, out_height,
    out_width): each frame's flattened features through an ``Mlp`` of
    width outchannel * out_height * out_width. No model of the repository
    builds it."""

    def __init__(self, in_features: int, outchannel: int, out_height: int,
                 out_width: int):
        super().__init__()
        self.shape = (outchannel, out_height, out_width)
        outdim = outchannel * out_height * out_width
        self.mlp = Mlp(in_features, outdim, outdim)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        n, f = audio.shape[:2]
        out = self.mlp(audio.reshape(n, f, -1).to(self.mlp.fc1.weight.dtype))
        return out.reshape((n, f) + self.shape)
