"""The training trunks on the kernels, forward and hand-derived backward, as
``posediffusion_tpu.ops.vit_train_kernel`` (``fused_vit_trunk_train``,
``fused_encoder_trunk_train``).

The TPU kernels (``_fwd_call`` / ``_bwd_call``) keep a batch chunk's
activations and cotangents in VMEM across all layers. A Hopper block cannot,
so here each layer is a sequence of launches over the whole batch:

* forward, per layer: LayerNorm, QKV product, attention (dropout of p),
  output product + residual (dropout m1), LayerNorm, FF product +
  activation (dropout mff), FF product + residual (dropout m2). It saves
  each block's input x and the post-attention x1 (both at the full batch:
  80 GB allows it), so the backward's MLP half needs no attention
  re-forward.
* DINOv2's LayerScale (``layer_scale``, the gains ``LS_KEYS``): the output
  and second FF products multiply their columns by ls1 / ls2 in the
  epilogue (``_attn_residual`` :211, ``_mlp_residual`` :239), and also write
  their pre-gain outputs o_pre, which the forward saves beside x and x1
  (6.57 GB more at 512 images x 348 tokens). The TPU kernel recomputes those
  products for the gains' gradients (:317, :440-455); the saved o_pre spares
  that. In the backward ``layerscale_bwd`` takes the place of the m1 / m2
  dropout backward: it gives the gain's gradient sum(do * o_pre) and the
  cotangent do * gamma (:316-319, :436-456).
* backward, per layer in reverse, as ``_trunk_bwd_kernel`` (:595-720): the
  MLP half from the saved x1 (LayerNorm and the first FF product
  recomputed), then the attention half from the saved x (LayerNorm, QKV and
  attention recomputed; not the output products, whose results the
  backward does not read), each with the closed-form VJPs of ``_mlp_residual_bwd`` and
  ``_attn_residual_bwd``: dgrad products dY W^T (``linear`` with
  ``trans_w``), weight gradients X^T dY as float32 row-split partials
  (``linear_wgrad``), the attention backward (``attention_bwd``), the
  activation and dropout backward (``act_dropout_bwd``) and the LayerNorm
  backward with the residual cotangent added (``layernorm_bwd``).
* DINOv2 ViT-g/14's SwiGLU feed-forward (``act="swiglu"``, which the TPU
  kernels do not have): the stacks hold w12's two halves interleaved by
  column (``stack_vit_params_train``: x1 and x2 of hidden column j at
  columns 2j and 2j + 1 of ``wfc1``), so the first FF product gates its
  column pairs in its epilogue (``linear(..., act="swiglu")``) and writes
  the (rows, H) hidden, never the (rows, 2H) x12; the backward recomputes
  that product with its pre-activation, and ``swiglu_bwd`` takes the place
  of ``act_dropout_bwd``: (dx1, dx2) = (dh x2 silu'(x1), dh silu(x1)), in
  front of the same dgrad and wgrad products. No dropout and no bf16 mode
  with it (the trunk refuses both).
* spans (``utils/profiling.span``, on a card): ``pd.<name>.ffn.fwd`` /
  ``.bwd`` around each layer's feed-forward half (LayerNorm 2, both FF
  products with the activation or gate, the residual and LayerScale
  epilogue; in the backward the recompute, the gain's, activation's or
  gate's backward, the dgrads, the wgrads and ``layernorm_bwd``), and with
  SwiGLU ``pd.<name>.gate.fwd`` / ``.bwd`` around the gated product, its
  recompute and ``swiglu_bwd``. On the CPU (the plain route launches
  nothing on a card) the trunk opens only ``pd.<name>.fwd`` / ``.bwd``.

Weights are float32 stacks (the optimizer's precision); ``act_bf16`` feeds
the products bf16 copies of them and rounds their activation operands, as
the TPU kernel's ``cast``; ``residual_bf16`` rounds the residual stream (the
JAX package's bf16 ``residual_dtype``), which stays a float32 tensor here.
Dropout masks are hashed from (seed, layer, site, element)
(``kernels.drop_args``), so the backward draws the forward's masks.

``ops`` is ``kernels.KERNELS`` (kernels on a card, plain versions on the
CPU), or ``kernels.PLAIN`` (the same hand-derived math in plain PyTorch on
any device) for trunks built inside ``plain_route()``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from posediffusion_tpu_torch.ops.kernels import KERNELS, PLAIN, drop_args
from posediffusion_tpu_torch.utils.profiling import NO_SPAN, span

WEIGHT_KEYS = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj",
               "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")
LS_KEYS = ("ls1", "ls2")  # DINOv2 LayerScale gains (D,), after the weights


@dataclasses.dataclass(frozen=True)
class TrunkSpec:
    """What a train trunk computes, besides its tensors."""

    nhead: int
    eps: float
    act: str  # "gelu" (ViT), "swiglu" (ViT-g/14's gated FF) or "relu" (denoiser)
    act_bf16: bool = False
    residual_bf16: bool = False
    dropout: float = 0.0
    seed: int = 0
    plain: bool = False  # PLAIN ops on any device (``plain_route``)
    layer_scale: bool = False  # DINOv2's ls1 / ls2 gains (``LS_KEYS``)
    name: str = "trunk"  # its spans pd.<name>.fwd / .bwd (``utils/profiling.span``)

    def __post_init__(self):
        if self.act == "swiglu" and (self.act_bf16 or self.residual_bf16 or self.dropout):
            raise NotImplementedError("the SwiGLU trunk has no bf16 mode and no dropout: "
                                      "dinov2_vitg14 trains at float32")

    def drop(self, layer: int, site: str):
        return drop_args(self.seed, layer, site, self.dropout)

    def span(self, part: str, x: torch.Tensor):
        """The span ``pd.<name>.<part>`` where the trunk runs on a card (its
        device time is what the span is for), else the null context."""
        return span(f"{self.name}.{part}") if x.is_cuda else NO_SPAN

    @property
    def keys(self):
        """The weight stacks' names, in the order the trunk takes them."""
        return WEIGHT_KEYS + (LS_KEYS if self.layer_scale else ())

    @property
    def ops(self):
        return PLAIN if self.plain else KERNELS


# ---------------------------------------------------------------- stacking
def interleave_halves(t: torch.Tensor) -> torch.Tensor:
    """The last axis of (..., 2H) [x1 | x2] as (..., H, 2), a view: x1[j]
    and x2[j] side by side, so a flattened copy has them at 2j and 2j + 1."""
    return t.unflatten(-1, (2, t.shape[-1] // 2)).transpose(-1, -2)


def _stack_interleaved(tensors):
    """Stack (..., 2H) tensors with their halves interleaved
    (``interleave_halves``), in one copy: (L, ..., 2H) float32."""
    return torch.stack([interleave_halves(t) for t in tensors]).flatten(-2).to(torch.float32)


def stack_vit_params_train(vit) -> dict:
    """``VisionTransformer`` blocks -> float32 per-array stacks (matrices
    (in, out)), built differentiably so gradients reach the parameters; with
    the LayerScale gains ``ls1`` / ``ls2`` (L, D) when the blocks have them.
    SwiGLU blocks (``vit.ffn == "swiglu"``) give ``wfc1`` / ``bfc1`` from
    w12 with its halves interleaved by column, (L, D, 2H) / (L, 2H), and
    ``wfc2`` / ``bfc2`` from w3."""
    b = vit.blocks
    stacks = {
        "g1": _stack_grad([x.norm1.weight for x in b]),
        "b1": _stack_grad([x.norm1.bias for x in b]),
        "wqkv": _stack_grad([x.attn.qkv.weight.t() for x in b]),
        "bqkv": _stack_grad([x.attn.qkv.bias for x in b]),
        "wproj": _stack_grad([x.attn.proj.weight.t() for x in b]),
        "bproj": _stack_grad([x.attn.proj.bias for x in b]),
        "g2": _stack_grad([x.norm2.weight for x in b]),
        "b2": _stack_grad([x.norm2.bias for x in b]),
    }
    if vit.ffn == "swiglu":
        stacks.update(wfc1=_stack_interleaved([x.mlp.w12.weight.t() for x in b]),
                      bfc1=_stack_interleaved([x.mlp.w12.bias for x in b]),
                      wfc2=_stack_grad([x.mlp.w3.weight.t() for x in b]),
                      bfc2=_stack_grad([x.mlp.w3.bias for x in b]))
    else:
        stacks.update(wfc1=_stack_grad([x.mlp.fc1.weight.t() for x in b]),
                      bfc1=_stack_grad([x.mlp.fc1.bias for x in b]),
                      wfc2=_stack_grad([x.mlp.fc2.weight.t() for x in b]),
                      bfc2=_stack_grad([x.mlp.fc2.bias for x in b]))
    if vit.layer_scale:
        stacks["ls1"] = _stack_grad([x.ls1.gamma for x in b])
        stacks["ls2"] = _stack_grad([x.ls2.gamma for x in b])
    return stacks


def stack_encoder_trunk_params(trunk) -> dict:
    """Denoiser ``TransformerEncoder`` layers -> the same float32 stacks
    under the shared key names, built differentiably."""
    L = trunk.layers
    return {
        "g1": _stack_grad([x.norm1.weight for x in L]),
        "b1": _stack_grad([x.norm1.bias for x in L]),
        "wqkv": _stack_grad([x.self_attn.in_proj_weight.t() for x in L]),
        "bqkv": _stack_grad([x.self_attn.in_proj_bias for x in L]),
        "wproj": _stack_grad([x.self_attn.out_proj.weight.t() for x in L]),
        "bproj": _stack_grad([x.self_attn.out_proj.bias for x in L]),
        "g2": _stack_grad([x.norm2.weight for x in L]),
        "b2": _stack_grad([x.norm2.bias for x in L]),
        "wfc1": _stack_grad([x.linear1.weight.t() for x in L]),
        "bfc1": _stack_grad([x.linear1.bias for x in L]),
        "wfc2": _stack_grad([x.linear2.weight.t() for x in L]),
        "bfc2": _stack_grad([x.linear2.bias for x in L]),
    }


def _stack_grad(tensors):
    return torch.stack(tensors).to(torch.float32).contiguous()


def _layer(s: TrunkSpec, weights, l: int):
    """Layer ``l``'s weights as a dict; matrices as the products take them
    (bf16 copies in the bf16 mode)."""
    w = {k: t[l] for k, t in zip(s.keys, weights)}
    if s.act_bf16:
        for k in ("wqkv", "wproj", "wfc1", "wfc2"):
            w[k] = w[k].to(torch.bfloat16)
    return w


# ------------------------------------------------------------ forward math
def _attn_branch(ops, s: TrunkSpec, l, w, x, B, N, attn_bias, key_bias):
    """x -> (h, qkv, a): LayerNorm, QKV and attention, what the output
    projection reads (the backward recomputes these and no more)."""
    M = x.shape[0]
    h = ops.layernorm(x, w["g1"], w["b1"], s.eps)
    qkv = ops.linear(h, w["wqkv"], w["bqkv"], round_a=s.act_bf16)
    a = ops.attention(qkv.view(B, N, -1), s.nhead, attn_bias=attn_bias,
                      key_bias=key_bias, round_in=s.act_bf16,
                      drop=s.drop(l, "attn")).view(M, -1)
    return h, qkv, a


def _with_pre(s: TrunkSpec, out):
    """A branch product's result as (out, o_pre): the pre-gain output that
    ``want_pre`` returns with LayerScale, else None."""
    return out if s.layer_scale else (out, None)


def _attn_half(ops, s: TrunkSpec, l, w, x, B, N, attn_bias, key_bias):
    """x -> (x1, o_pre): the attention branch, then the projection [x ls1]
    + x; o_pre is the projection before the gain (LayerScale only)."""
    a = _attn_branch(ops, s, l, w, x, B, N, attn_bias, key_bias)[2]
    return _with_pre(s, ops.linear(
        a, w["wproj"], w["bproj"], residual=x, round_a=s.act_bf16, drop=s.drop(l, "m1"),
        round_out=s.residual_bf16, gain=w.get("ls1"), want_pre=s.layer_scale))


def _gate_span(s: TrunkSpec, way: str, x):
    """``pd.<name>.gate.<way>`` around the gate's calls (SwiGLU only)."""
    return s.span("gate." + way, x) if s.act == "swiglu" else NO_SPAN


def _mlp_branch(ops, s: TrunkSpec, l, w, x1, want_pre=False):
    """x1 -> (h, hidden) (with ``want_pre``, (h, hidden, pre-activation)):
    LayerNorm and the first FF product with its activation and dropout, or
    its gate (the backward's recompute with ``want_pre``)."""
    h = ops.layernorm(x1, w["g2"], w["b2"], s.eps)
    with _gate_span(s, "bwd" if want_pre else "fwd", x1):
        hm = ops.linear(h, w["wfc1"], w["bfc1"], act=s.act, round_a=s.act_bf16,
                        drop=s.drop(l, "mff"), want_pre=want_pre)
    return (h, *hm) if want_pre else (h, hm)


def _mlp_half(ops, s: TrunkSpec, l, w, x1):
    """x1 -> (y, o_pre): the MLP branch, then the second FF product [x ls2]
    + x1; o_pre as in ``_attn_half``."""
    with s.span("ffn.fwd", x1):
        hm = _mlp_branch(ops, s, l, w, x1)[1]
        return _with_pre(s, ops.linear(
            hm, w["wfc2"], w["bfc2"], residual=x1, round_a=s.act_bf16, drop=s.drop(l, "m2"),
            round_out=s.residual_bf16, gain=w.get("ls2"), want_pre=s.layer_scale))


def trunk_forward(s: TrunkSpec, x, weights, attn_bias=None, key_bias=None,
                  save: bool = False):
    """All layers on x (B, N, D) -> (y (B, N, D), per layer when ``save``
    (x, x1, o1_pre, o2_pre), (B*N, D) each; the o_pre are None without
    LayerScale).

    Under autograd with ``PLAIN`` ops this is also a differentiable reference
    of the trunk (``torch.autograd`` of the plain forward)."""
    B, N, D = x.shape
    ops = s.ops
    h = x.reshape(B * N, D)
    L = weights[0].shape[0]
    saved = []
    for l in range(L):
        w = _layer(s, weights, l)
        x1, o1 = _attn_half(ops, s, l, w, h, B, N, attn_bias, key_bias)
        y, o2 = _mlp_half(ops, s, l, w, x1)
        if save:
            saved.append((h, x1, o1, o2))
        h = y
    return h.view(B, N, D), saved


# ----------------------------------------------------------- backward math
def _drop_bwd(ops, s: TrunkSpec, l, w, dy, site, o_pre, grads):
    """The cotangent of a branch's product output from that of the branch:
    the site's dropout backward, and with LayerScale the gain's (whose
    gradient goes into ``grads``)."""
    drop = s.drop(l, site)
    if s.layer_scale:
        ls = "ls1" if site == "m1" else "ls2"
        do, grads[ls][l] = ops.layerscale_bwd(dy, o_pre, w[ls], drop)
        return do
    return dy if drop is None else ops.act_dropout_bwd(dy, None, "none", drop)


def _mlp_half_bwd(ops, s: TrunkSpec, l, w, x1, dy, grads, o_pre=None):
    """``_mlp_residual_bwd``: cotangent dy of y -> cotangent of x1."""
    with s.span("ffn.bwd", x1):
        h, hm, a1 = _mlp_branch(ops, s, l, w, x1, want_pre=True)
        do = _drop_bwd(ops, s, l, w, dy, "m2", o_pre, grads)
        grads["wfc2"][l], grads["bfc2"][l] = ops.linear_wgrad(hm, do, s.act_bf16)
        dhm = ops.linear(do, w["wfc2"], None, trans_w=True, round_a=s.act_bf16)
        if s.act == "swiglu":
            with _gate_span(s, "bwd", x1):
                da1 = ops.swiglu_bwd(dhm, a1)
        else:
            da1 = ops.act_dropout_bwd(dhm, a1, s.act, s.drop(l, "mff"))
        grads["wfc1"][l], grads["bfc1"][l] = ops.linear_wgrad(h, da1, s.act_bf16)
        dh = ops.linear(da1, w["wfc1"], None, trans_w=True, round_a=s.act_bf16)
        dx1, grads["g2"][l], grads["b2"][l] = ops.layernorm_bwd(
            x1, w["g2"], dh, s.eps, residual=dy, round_out=s.residual_bf16)
        return dx1


def _attn_half_bwd(ops, s: TrunkSpec, l, w, x, dx1, B, N, attn_bias, key_bias,
                   grads, o_pre=None):
    """``_attn_residual_bwd``: cotangent dx1 of x1 -> cotangent of x."""
    h, qkv, a = _attn_branch(ops, s, l, w, x, B, N, attn_bias, key_bias)
    do = _drop_bwd(ops, s, l, w, dx1, "m1", o_pre, grads)
    grads["wproj"][l], grads["bproj"][l] = ops.linear_wgrad(a, do, s.act_bf16)
    da = ops.linear(do, w["wproj"], None, trans_w=True, round_a=s.act_bf16)
    dqkv = ops.attention_bwd(qkv.view(B, N, -1), da.view(B, N, -1), s.nhead,
                             attn_bias=attn_bias, key_bias=key_bias,
                             round_in=s.act_bf16, drop=s.drop(l, "attn"))
    dqkv = dqkv.view(B * N, -1)
    grads["wqkv"][l], grads["bqkv"][l] = ops.linear_wgrad(h, dqkv, s.act_bf16)
    dh = ops.linear(dqkv, w["wqkv"], None, trans_w=True, round_a=s.act_bf16)
    dx, grads["g1"][l], grads["b1"][l] = ops.layernorm_bwd(
        x, w["g1"], dh, s.eps, residual=dx1, round_out=s.residual_bf16)
    return dx


def trunk_backward(s: TrunkSpec, saved, dy, weights, attn_bias=None,
                   key_bias=None):
    """Cotangent dy (B, N, D) of the trunk's output -> (dx, weight grads in
    ``s.keys`` order, float32 stacks)."""
    B, N, D = dy.shape
    ops = s.ops
    grads = {k: torch.empty_like(t) for k, t in zip(s.keys, weights)}
    g = dy.reshape(B * N, D).to(torch.float32).contiguous()
    if s.residual_bf16:  # the cotangent enters at the residual type
        g = g.to(torch.bfloat16).to(torch.float32)
    for l in reversed(range(len(saved))):
        x, x1, o1, o2 = saved[l]
        w = _layer(s, weights, l)
        g = _mlp_half_bwd(ops, s, l, w, x1, g, grads, o2)
        g = _attn_half_bwd(ops, s, l, w, x, g, B, N, attn_bias, key_bias, grads, o1)
    return g.view(B, N, D), [grads[k] for k in s.keys]


class _TrainTrunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, attn_bias, key_bias, spec: TrunkSpec, *weights):
        with span(spec.name + ".fwd"), torch.no_grad():
            y, saved = trunk_forward(spec, x.contiguous(), weights, attn_bias,
                                     key_bias, save=True)
        ctx.spec = spec
        ctx.saved = saved  # activations, not inputs: kept off save_for_backward
        ctx.save_for_backward(attn_bias, key_bias, *weights)
        return y

    @staticmethod
    def backward(ctx, dy):
        attn_bias, key_bias, *weights = ctx.saved_tensors
        with span(ctx.spec.name + ".bwd"), torch.no_grad():
            dx, dw = trunk_backward(ctx.spec, ctx.saved, dy, weights, attn_bias,
                                    key_bias)
        ctx.saved = None
        return (dx, None, None, None, *dw)


_plain_route = False


@contextlib.contextmanager
def plain_route():
    """Trunks built inside this block take the plain PyTorch route on any
    device, forward and backward (the route is fixed when the trunk runs
    forward): a whole train step's kernel-against-plain comparison."""
    global _plain_route
    before, _plain_route = _plain_route, True
    try:
        yield
    finally:
        _plain_route = before


def train_trunk(x, stacks, spec: TrunkSpec, attn_bias=None, key_bias=None):
    """The differentiable trunk that ``spec`` describes, on x (B, N, D)
    float32: on the kernels, or inside ``plain_route()`` in plain PyTorch."""
    if _plain_route:
        spec = dataclasses.replace(spec, plain=True)
    if x.dtype != torch.float32:
        raise TypeError(f"train trunk input must be float32, got {x.dtype}")
    if spec.residual_bf16:
        x = x.to(torch.bfloat16).to(torch.float32)  # the residual_dtype cast
    weights = [stacks[k] for k in spec.keys]
    return _TrainTrunk.apply(x, attn_bias, key_bias, spec, *weights)


def fused_vit_trunk_train(
    x: torch.Tensor,  # (B, N, D) float32 tokens
    stacks: dict,  # stack_vit_params_train
    attn_bias: torch.Tensor,  # (N, N) additive, pre-softmax, no gradient
    nhead: int = 6,
    act_bf16: bool = False,
    residual_bf16: bool = False,
    layer_scale: bool = False,
    act: str = "gelu",
) -> torch.Tensor:
    """Differentiable ViT trunk (GELU, or with ``act="swiglu"`` DINOv2's
    gated feed-forward over interleaved ``wfc1`` stacks; LayerNorm eps 1e-6,
    shared (N, N) bias, no dropout; with ``layer_scale`` DINOv2's gains
    ``ls1`` / ``ls2`` from the stacks): forward and backward on the kernels.
    Gradients reach x and the stacks."""
    spec = TrunkSpec(nhead=nhead, eps=1e-6, act=act, act_bf16=act_bf16,
                     residual_bf16=residual_bf16, layer_scale=layer_scale,
                     name="vit_trunk")
    return train_trunk(x, stacks, spec, attn_bias=attn_bias.contiguous())


def fused_encoder_trunk_train(
    x: torch.Tensor,  # (B, N, D) float32 tokens
    stacks: dict,  # stack_encoder_trunk_params
    key_bias: torch.Tensor,  # (B, N) additive key bias (0 / NEG), no gradient
    seed: int = 0,
    nhead: int = 4,
    act_bf16: bool = False,
    residual_bf16: bool = False,
    dropout: float = 0.0,
) -> torch.Tensor:
    """Differentiable denoiser trunk (torch TransformerEncoder semantics:
    pre-norm, ReLU, LayerNorm eps 1e-5, dropout at the four sites)."""
    spec = TrunkSpec(nhead=nhead, eps=1e-5, act="relu", act_bf16=act_bf16,
                     residual_bf16=residual_bf16, dropout=dropout,
                     seed=int(seed), name="encoder_trunk")
    return train_trunk(x, stacks, spec, key_bias=key_bias.contiguous())


def trunk_reference(x, stacks, spec: TrunkSpec, attn_bias=None,
                    key_bias=None) -> torch.Tensor:
    """The trunk's plain forward under autograd (no custom backward): the
    yardstick of the hand-derived backward."""
    spec = dataclasses.replace(spec, plain=True)
    if spec.residual_bf16:
        x = x.to(torch.bfloat16).to(torch.float32)
    return trunk_forward(spec, x, [stacks[k] for k in spec.keys], attn_bias,
                         key_bias)[0]
