"""The hand-written Hopper kernels, their plain PyTorch versions, and routing.

Eighteen wrappers (sources in ``posediffusion_tpu_torch/csrc``) carry the TPU
kernels of the inference paths with and without GGS, of match extraction and
of the training trunks (DINOv2's LayerScale and ViT-g/14's SwiGLU gate
included):

=======================  =====================================================
``layernorm``            row LayerNorm, eps and bf16 output rounding as arguments
``linear``               ``drop(act(a @ W + b) * gain) [+ residual]``, W float32
                         or bfloat16, read transposed for the dgrad product;
                         ``act="swiglu"`` gates column pairs of a float32
                         product in its epilogue, silu(x1) * x2 (on TF32
                         ``wgmma`` only);
                         float32 a and W as 3xTF32 on TF32 ``wgmma`` fed by
                         TMA (else 3xTF32 ``mma.sync``), a bf16 W with
                         ``round_a`` on bf16 ``wgmma`` fed by TMA
``linear_rows``          the same for at most 32 rows (the sampler's products):
                         W streamed once over a cluster split of K, with the
                         pre-norm LayerNorm of a optionally folded in
``attention``            softmax attention over a packed (B, N, 3D) QKV buffer,
                         optional dropout of the normalised p
``sampler_prologue``     layer-0 fold-in of the fused sampler (step 0)
``sampler_epilogue``     head MLP + posterior update of the fused sampler
                         (the last step)
``sampler_boundary``     the two in one launch between two steps (one
                         thread-block cluster kernel serves all three)
``ggs_phase``            one whole GGS SGD phase, one block
``ggs_phase_chunked``    the same over a thread-block cluster, the pairs
                         split between its blocks
``superglue_coupling``   SuperGlue pair scores into the dustbin coupling
                         (3xTF32 tensor-core tiles, masked tiles skipped)
``superglue_sinkhorn``   log-domain Sinkhorn over the coupling -> log assignment
``superglue_matches``    mutual-max matches above a threshold
``attention_bwd``        dQKV of ``attention`` from its output cotangent
``layernorm_bwd``        LayerNorm dx (+ residual cotangent), dg and db
``linear_wgrad``         weight and bias gradients X^T dY, colsum(dY)
``act_dropout_bwd``      dropout mask times GELU' or ReLU' of the cotangent
``layerscale_bwd``       LayerScale's cotangent and gain gradient, dropout mask
``swiglu_bwd``           the gate's cotangent: (dx1, dx2) from dh and (x1, x2)
=======================  =====================================================

Dropout masks come from a counter hash of (seed, layer, site, element)
(``drop_args``, ``dropout_mask``; csrc/common.cuh): the kernels and the
plain versions draw the same bits.

Routing is by the tensors' device and nothing else: on a CUDA tensor a
wrapper launches its kernel (or raises), on a CPU tensor it calls the plain
version beside it. Each plain version computes the same math with the same
bf16 rounding sites and weight dtypes; the CPU tests hold it against the JAX
package and ``chip_smoke.py`` holds each kernel against it on the card.

The kernels are compiled with ``nvcc`` (one process per source, in parallel)
and linked into one shared library at first use (``build/kernels/``, keyed
by a hash of the sources), then bound with ctypes.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from posediffusion_tpu_torch.ops.ggs_grad import GGSTables, loss_and_grad_core

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
NEG = -1e30  # additive bias of a masked key (never -inf: no row gives NaN)

_ACT = {"none": 0, "relu": 1, "gelu": 2, "swiglu": 3}
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float
_DROP = [_U, _I, _F]  # a dropout site: key, threshold, scale (DropArgs)
_SIGNATURES = {
    "pd_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "pd_linear": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, *_DROP, _I, _P, _P],
    "pd_linear_bf16_smem_bytes": [],
    "pd_linear_tf32_wgmma_smem_bytes": [],
    "pd_linear_route": [_I] * 6,
    "pd_linear_rows": [_P, _P, _I] + [_P] * 7 + [_F] + [_I] * 6 + [*_DROP, _I, _P],
    "pd_attention": [_P, _P, _I, _P, _I, _I, _I, _I, _F, _I, *_DROP, _P],
    "pd_attention_smem_bytes": [_I, _I, _I],
    "pd_sampler_step": [_P] * 16 + [_I] * 7 + [_F, _I, _P],
    "pd_sampler_smem_bytes": [_I] * 5,
    "pd_sampler_max_active_clusters": [_I] * 5,
    "pd_ggs_phase": [_P] * 11 + [_I] * 8 + [_F, _I, _F, _F, _F, _F, _P],
    "pd_ggs_phase_chunked": [_P] * 11 + [_I] * 8 + [_F, _I, _F, _F, _F, _F, _I, _P],
    "pd_ggs_smem_bytes": [_I] * 4,
    "pd_ggs_max_active_clusters": [_I] * 4,
    "pd_sg_coupling": [_P] * 9 + [_I, _I, _I, _F, _P],
    "pd_sg_scores_scratch": [_I, _I],
    "pd_sg_sinkhorn": [_P] * 7 + [_I, _I, _I, _P],
    "pd_sg_matches": [_P] * 6 + [_I, _I, _F, _P],
    "pd_attention_bwd": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _I, *_DROP, _P],
    "pd_attention_bwd_smem_bytes": [_I, _I],
    "pd_layernorm_bwd": [_P] * 7 + [_I, _I, _F, _I, _P],
    "pd_layernorm_bwd_blocks": [_I],
    "pd_linear_wgrad": [_P] * 4 + [_I] * 5 + [_P],
    "pd_linear_wgrad_tile": [_I],
    "pd_linear_wgrad_route": [_I] * 5,
    "pd_linear_wgrad_tf32_smem_bytes": [],
    "pd_act_dropout_bwd": [_P, _P, _P, _L, _I, *_DROP, _P],
    "pd_sum_partials": [_P, _P, _I, _L, _P],
    "pd_layerscale_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, *_DROP, _P],
    "pd_swiglu_bwd": [_P, _P, _P, _L, _P],
}
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


# --------------------------------------------------------------------- build
def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"libposediffusion_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds) -> None:
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}\n{err}")


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc -c`` per source, all started
    together) and link them into one shared library, unless the build for
    these exact sources exists already."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        objs = []
        compiles = []
        for src in sorted(_CSRC.glob("*.cu")):
            obj = os.path.join(tmpdir, src.stem + ".o")
            objs.append(obj)
            compiles.append([_nvcc(), *_NVCC_FLAGS, "-c", "-o", obj, str(src)])
        _run_all(compiles)
        tmp = os.path.join(tmpdir, path.name)
        _run_all([[_nvcc(), *_NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
    return path


@functools.cache
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# ------------------------------------------------------------------- helpers
def _on_card(*tensors: Optional[torch.Tensor]) -> bool:
    """True when the kernel must run (CUDA tensors), False for the plain
    version (CPU tensors). Anything else raises."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    if any(t.device != dev for t in present):
        raise ValueError(f"tensors on different devices: {[t.device for t in present]}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel route for device {dev}")


def _check(t: Optional[torch.Tensor], name: str, shape, dtypes=(torch.float32,)):
    if t is None:
        return
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


# ------------------------------------------------------------------- dropout
# The four dropout sites of a torch TransformerEncoderLayer, in the order of
# posediffusion_tpu/ops/vit_train_kernel.py _DROP_SITES: the attention
# probabilities, after the output projection, after the FF activation, after
# the second FF product.
DROP_SITES = ("attn", "m1", "mff", "m2")
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Drop:
    """One dropout site of one layer: the hash key, the 23-bit threshold and
    the keep scale (csrc/common.cuh, DropArgs)."""

    key: int
    thr: int
    scale: float

    def args(self):
        return (self.key, self.thr, self.scale)


_NO_DROP = (0, 0, 1.0)


def _fmix32(h: int) -> int:
    """murmur3's 32-bit finaliser on a Python int (common.cuh, pd_fmix32)."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def drop_args(seed: int, layer: int, site: str, rate: float) -> Optional[Drop]:
    """The mask parameters of ``site`` in ``layer`` for dropout seed ``seed``;
    None when ``rate`` is 0. An element is kept when the low 23 bits of its
    hash are >= ceil(rate * 2^23), the TPU kernel's rule u >= rate on a
    23-bit uniform (posediffusion_tpu/ops/vit_train_kernel.py:121-128)."""
    if rate <= 0.0:
        return None
    if rate >= 1.0:
        raise ValueError(f"dropout rate {rate} must be below 1")
    stream = layer * len(DROP_SITES) + DROP_SITES.index(site) + 1
    key = _fmix32(_fmix32(int(seed) & _M32) ^ ((stream * 0x9E3779B9) & _M32))
    thr = math.ceil(float(np.float32(rate)) * (1 << 23))
    return Drop(key, thr, float(np.float32(1.0 / (1.0 - rate))))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 tensors holding uint32 values, in two
    16-bit halves of c so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32_t(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def dropout_mask(drop: Optional[Drop], shape, device) -> Optional[torch.Tensor]:
    """The float32 multipliers (0 or 1 / (1 - rate)) of a row-major tensor of
    ``shape``, element i from the hash of i: the same integer steps as the
    kernels, so masks agree bitwise. None when ``drop`` is None."""
    if drop is None:
        return None
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=device)
    bits = _fmix32_t(_fmix32_t(i) ^ drop.key) & 0x7FFFFF
    keep = torch.tensor(drop.scale, dtype=torch.float32, device=device)
    return torch.where(bits >= drop.thr, keep, 0.0).view(shape)


# ----------------------------------------------------------------- layernorm
def layernorm_plain(x, g, b, eps: float, round_out: bool = False):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * g + b
    return round_bf16(y) if round_out else y


def layernorm(x, g, b, eps: float, round_out: bool = False):
    """LayerNorm over the last axis of a float32 (rows, D) tensor. Counts its
    launches in ``layernorm.launches`` and, per (rows, D), in
    ``layernorm.by_shape``."""
    if not _on_card(x, g, b):
        return layernorm_plain(x, g, b, eps, round_out)
    rows, D = x.shape
    _check(x, "x", (rows, D))
    _check(g, "g", (D,))
    _check(b, "b", (D,))
    y = torch.empty_like(x)
    _launch(load_library().pd_layernorm, _ptr(x), _ptr(g), _ptr(b), _ptr(y),
            rows, D, eps, int(round_out), _stream(x))
    layernorm.launches += 1
    layernorm.by_shape[(rows, D)] = layernorm.by_shape.get((rows, D), 0) + 1
    return y


layernorm.launches = 0
layernorm.by_shape = {}


# -------------------------------------------------------------------- linear
def silu(x):
    """x sigmoid(x) as the kernels compute it, x / (1 + exp(-x))."""
    return x / (1.0 + torch.exp(-x))


def swiglu_plain(pre):
    """The gate over a product's interleaved columns: column 2j is x1 and
    2j + 1 is x2 of hidden column j -> silu(x1) * x2, half as wide."""
    return silu(pre[..., 0::2]) * pre[..., 1::2]


def _activate(y, act: str):
    if act == "relu":
        return torch.relu(y)
    if act == "gelu":  # exact erf GELU (torch nn.GELU)
        return 0.5 * y * (1.0 + torch.erf(y * (2.0**-0.5)))
    if act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y


def linear_plain(a, w, bias, act: str = "none", residual=None,
                 round_a: bool = False, trans_w: bool = False,
                 drop: Optional[Drop] = None, round_out: bool = False,
                 want_pre: bool = False, gain=None, ln=None):
    if ln is not None:
        a = layernorm_plain(a, *ln)
    if round_a:
        a = round_bf16(a)
    wf = w.float()
    pre = a @ (wf.t() if trans_w else wf)
    if bias is not None:
        pre = pre + bias
    if act == "swiglu":
        _swiglu_check(pre.shape[-1], w.dtype, residual, round_a, drop, gain, trans_w)
        y = swiglu_plain(pre)
        return (y, pre) if want_pre else y
    y = _activate(pre, act)
    if gain is not None:
        y = y * gain
    if drop is not None:
        y = y * dropout_mask(drop, y.shape, y.device)
    if residual is not None:
        if round_out:
            y = round_bf16(y)
        y = y + residual
        if round_out:
            y = round_bf16(y)
    return (y, pre) if want_pre else y


def _swiglu_check(N: int, w_dtype, residual, round_a, drop, gain, trans_w) -> None:
    """The gated product is a forward float32 product of an even width with
    no residual, gain or dropout: what the SwiGLU feed-forward's w12 takes."""
    if N % 2:
        raise ValueError(f"act swiglu gates column pairs: N {N} is odd")
    if w_dtype != torch.float32 or round_a:
        raise NotImplementedError("act swiglu has no bf16 mode (a bf16 W or round_a): "
                                  "the SwiGLU ViT trains and serves at float32")
    if residual is not None or drop is not None or gain is not None or trans_w:
        raise ValueError("act swiglu takes no residual, gain, dropout or trans_w")


def _linear_check(a, w, bias, residual, gain, trans_w: bool):
    M, K = a.shape
    N = w.shape[0] if trans_w else w.shape[1]
    _check(a, "a", (M, K))
    _check(w, "w", (N, K) if trans_w else (K, N), (torch.float32, torch.bfloat16))
    _check(bias, "bias", (N,))
    _check(gain, "gain", (N,))
    _check(residual, "residual", (M, N))
    return M, K, N


def _ln_tensors(ln):
    return () if ln is None else tuple(ln[:2])


def linear(a, w, bias, act: str = "none", residual=None, round_a: bool = False,
           trans_w: bool = False, drop: Optional[Drop] = None,
           round_out: bool = False, want_pre: bool = False, gain=None, ln=None):
    """``drop(act(LN(a) @ W + bias) * gain) [+ residual]``; a (M, K) float32,
    W (K, N), or (N, K) with ``trans_w`` (the dgrad product dY W^T of a
    forward weight), float32 or bfloat16; bias and gain (N,) or None (gain:
    DINOv2's LayerScale); residual (M, N). ``round_out`` rounds the branch
    and the sum to bf16 (a bf16 residual stream); ``want_pre`` also returns
    the pre-activation ``LN(a) @ W + bias``. ``ln = (g, b, eps)`` applies
    ``layernorm`` to a first (round_a then rounds the normalised rows).
    ``act="swiglu"`` (float32 W, no residual, gain, dropout or trans_w) gates the
    product's interleaved columns, y[:, j] = silu(pre[:, 2j]) * pre[:, 2j
    + 1], so y is (M, N / 2) and ``want_pre`` returns the whole (M, N)
    pre-activation; it runs on the ``tf32_wgmma`` route at any row count,
    and operands that route cannot take raise.

    On the card, up to LINEAR_ROWS_MAX rows with W not transposed take the
    few-rows route (``linear_rows``), which alone folds ``ln``; asking for
    ``ln`` on any other route raises. The rest run on the tensor cores, by
    ``linear_route`` (csrc/linear.cu pd_linear mirrors it):

    * ``bf16_wgmma``: a bf16 W with ``round_a``, bf16 ``wgmma``
      (linear_bf16_wgmma_kernel: TMA-fed, a rounded to bf16 as it is
      loaded, 128 x 128 tiles).
    * ``tf32_wgmma``: a float32 W without ``round_a``, a and W on 16-byte
      boundaries, K and N multiples of 4 (rows TMA can address), down to a
      single 128 x 128 tile: 3xTF32 on TF32 ``wgmma``
      (tf32_split_kernel writes W's hi and lo TF32 halves K-major, the
      forward's transposed, into a scratch of 2 N K floats for the call;
      linear_tf32_wgmma_kernel loads them and a by TMA and splits a in
      registers; about 2^-21 relative a product). TF32 ``wgmma`` is the
      only way to the card's TF32 rate; it is bound by its three products
      at 495 TFLOP/s. The float32 train trunks' forward, recompute and
      dgrad products take it, and the f32 serving ViT's and SuperGlue's.
    * ``tf32_mma``: everything else (a bf16 W, ``round_a``, rows off 16
      bytes or K, N off 4, such as K 702 or N 9): 3xTF32 ``mma.sync``
      (linear_tf32_kernel; two TF32 products where the bf16 W or the
      rounded a is exact in TF32).

    Counts its launches in ``linear.launches``, per (M, K, N, trans_w) in
    ``linear.by_shape`` and per route in ``linear.by_route``."""
    if not _on_card(a, w, bias, residual, gain, *_ln_tensors(ln)):
        return linear_plain(a, w, bias, act, residual, round_a, trans_w, drop,
                            round_out, want_pre, gain, ln)
    gated = act == "swiglu"
    if a.shape[0] <= LINEAR_ROWS_MAX and not trans_w and not gated:
        return _linear_rows_launch(a, w, bias, act, residual, round_a, drop, round_out,
                                   want_pre, gain, ln)
    if ln is not None:
        raise ValueError(f"ln is folded only on the few-rows route (at most "
                         f"{LINEAR_ROWS_MAX} rows, W not transposed), not at "
                         f"{a.shape[0]} rows{' with trans_w' if trans_w else ''}")
    M, K, N = _linear_check(a, w, bias, residual, gain, trans_w)
    if gated:
        _swiglu_check(N, w.dtype, residual, round_a, drop, gain, trans_w)
    y = torch.empty((M, N // 2 if gated else N), device=a.device, dtype=torch.float32)
    pre = torch.empty((M, N), device=a.device, dtype=torch.float32) if want_pre else None
    bf16 = w.dtype == torch.bfloat16
    lib = load_library()
    route = LINEAR_ROUTES[lib.pd_linear_route(
        K, N, int(bf16), int(round_a), int(a.data_ptr() % 16 == 0), int(w.data_ptr() % 16 == 0))]
    if gated and route != "tf32_wgmma":
        raise ValueError(f"act swiglu runs on the tf32_wgmma route only (a and W on 16-byte "
                         f"boundaries, K and N multiples of 4), not on {route} at K {K}, N {N}")
    # W's TF32 halves for this call only (2 N K floats, at most 4.7 MB on the
    # train path): nothing split outlives the call
    split = (torch.empty((2 * N, K), device=a.device, dtype=torch.float32)
             if route == "tf32_wgmma" else None)
    _launch(lib.pd_linear, _ptr(a), _ptr(w), int(bf16), int(trans_w), _ptr(bias),
            _ptr(gain), _ptr(residual), _ptr(y), _ptr(pre), M, N, K, int(round_a),
            _ACT[act], *(drop.args() if drop else _NO_DROP), int(round_out), _ptr(split),
            _stream(a))
    linear.launches += 1
    key = (M, K, N, bool(trans_w))
    linear.by_shape[key] = linear.by_shape.get(key, 0) + 1
    linear.by_route[route] = linear.by_route.get(route, 0) + 1
    return (y, pre) if want_pre else y


linear.launches = 0
linear.by_shape = {}
linear.by_route = {}

LINEAR_ROUTES = ("tf32_mma", "tf32_wgmma", "bf16_wgmma")  # pd_linear_route's codes


def linear_route(K: int, N: int, w_bf16: bool, round_a: bool, aligned: bool = True) -> str:
    """The tensor-core route ``linear`` takes above the few-rows route, as
    csrc/linear.cu linear_route decides it (``linear`` asks pd_linear_route):
    ``bf16_wgmma`` for a bf16 W with ``round_a``; ``tf32_wgmma`` for a
    float32 W without ``round_a`` whose rows TMA can address (``aligned``: a
    and W on 16-byte boundaries; K and N multiples of 4); ``tf32_mma`` for
    the rest."""
    if w_bf16 and round_a:
        return "bf16_wgmma"
    if not w_bf16 and not round_a and aligned and K > 0 and K % 4 == 0 and N % 4 == 0:
        return "tf32_wgmma"
    return "tf32_mma"


# csrc/linear.cu linear_tf32_wgmma_kernel (struct Tw): tiles of
# LINEAR_TF32_WGMMA_ROWS rows (two consumer warpgroups of 64) by
# LINEAR_TF32_WGMMA_COLS columns, one persistent block an SM; a ring slot
# holds a 32-wide K slice of a and of W's hi and lo TF32 halves (16 KB each),
# and each consumer warpgroup passes its rows through an epilogue buffer 32
# columns at a time. Every train-trunk product of both cells tiles exactly (M
# 135,168, 178,176 or 46,080; K and N in 384, 512, 1,024, 1,152, 1,536).
LINEAR_TF32_WGMMA_ROWS = 128
LINEAR_TF32_WGMMA_COLS = 128
LINEAR_TF32_WGMMA_K = 32
LINEAR_TF32_WGMMA_STAGES = 4
LINEAR_TF32_WGMMA_EPI_COLS = 32


def linear_tf32_wgmma_smem_bytes() -> int:
    """Shared memory of the TF32 wgmma tile (csrc/linear.cu Tw::SMEM,
    pd_linear_tf32_wgmma_smem_bytes): 1,024 bytes of alignment slack, four
    ring slots (a's 128 x 32 float32 slice, W's hi and its lo, 128 x 32
    each), two epilogue buffers (64 rows of 32 + 8 floats) and a full and an
    empty barrier per slot."""
    slot = (LINEAR_TF32_WGMMA_ROWS + 2 * LINEAR_TF32_WGMMA_COLS) * LINEAR_TF32_WGMMA_K * 4
    epi = 2 * 64 * (LINEAR_TF32_WGMMA_EPI_COLS + 8) * 4
    return 1024 + LINEAR_TF32_WGMMA_STAGES * slot + epi + 2 * LINEAR_TF32_WGMMA_STAGES * 8


# csrc/linear.cu linear_bf16_wgmma_kernel: tiles of LINEAR_BF16_ROWS rows
# (two consumer warpgroups of 64) by LINEAR_BF16_COLS columns, one
# persistent block an SM; a ring slot holds a 64-wide K slice of a (float32)
# and of W (bf16). At the serving ViTs' products (20 frames):
#
#   M             K -> N                  tiles   waves on 132 SMs
#   5,280 (224px) 384 -> 1,152            378     3
#   5,280         384 -> 384              126     1 (6 SMs idle)
#   5,280         384 -> 1,536            504     4
#   5,280         1,536 -> 384            126     1 (6 SMs idle)
#   11,860 (336)  384 -> 1,152            837     7
#   11,860        384 -> 384              279     3
#   11,860        384 -> 1,536            1,116   9
#   11,860        1,536 -> 384            279     3
#   5,280 ViT-B   768 -> 2,304            756     6
#   5,280 ViT-B   768 -> 768              252     2
#   5,280 ViT-B   768 -> 3,072            1,008   8
#   5,280 ViT-B   3,072 -> 768            252     2
#
# A 64-wide tile adds waves at every one of these shapes (two of 252 tiles
# against one of 126 at 224px's N 384; 5 to 17 where 128 takes 3 to 9) and
# reads a's float32 slice, two thirds of a slot's bytes, twice as often, so
# there is one width.
LINEAR_BF16_ROWS = 128
LINEAR_BF16_COLS = 128
LINEAR_BF16_K = 64
LINEAR_BF16_STAGES = 3


def linear_bf16_smem_bytes() -> int:
    """Shared memory of the bf16 wgmma tile (csrc/linear.cu Bw::SMEM,
    pd_linear_bf16_smem_bytes): 1,024 bytes of alignment slack, three ring
    slots (a's 128 x 64 float32 slice and W's 64 x 128 bf16 one each), the
    two epilogue buffers (128 rows of 128 + 4 floats) and a full and an
    empty barrier per slot."""
    stage = LINEAR_BF16_ROWS * LINEAR_BF16_K * 4 + LINEAR_BF16_K * LINEAR_BF16_COLS * 2
    epi = LINEAR_BF16_ROWS * (LINEAR_BF16_COLS + 4) * 4
    return 1024 + LINEAR_BF16_STAGES * stage + epi + 2 * LINEAR_BF16_STAGES * 8


# csrc/linear.cu: FR_ROWS, the few-rows route's row limit; FR_CLUSTER, the
# blocks of a cluster that split K; a folded LayerNorm needs each block's
# slice of K in one staged chunk (FR_CLUSTER x FR_KCH).
LINEAR_ROWS_MAX = 32
LINEAR_ROWS_CLUSTER = 8
LINEAR_ROWS_LN_MAX_K = 8 * 128
_SMS = 132  # streaming multiprocessors of an H100 SXM


def linear_rows_tile(N: int) -> int:
    """Columns per block of the few-rows route: the widest of 64, 32 and 16
    whose ceil(N / tile) column tiles x LINEAR_ROWS_CLUSTER K slices still
    give every SM a block (16 at N 512, 32 at 1,024, 64 at 1,536)."""
    for tile in (64, 32):
        if -(-N // tile) * LINEAR_ROWS_CLUSTER >= _SMS:
            return tile
    return 16


def linear_rows_plain(a, w, bias, act: str = "none", residual=None,
                      round_a: bool = False, drop: Optional[Drop] = None,
                      round_out: bool = False, want_pre: bool = False, gain=None,
                      ln=None):
    return linear_plain(a, w, bias, act, residual, round_a, False, drop, round_out,
                        want_pre, gain, ln)


def linear_rows(a, w, bias, act: str = "none", residual=None,
                round_a: bool = False, drop: Optional[Drop] = None,
                round_out: bool = False, want_pre: bool = False, gain=None,
                ln=None):
    """The few-rows route of ``linear`` (csrc/linear.cu, linear_rows_kernel):
    a (M, K) with M <= LINEAR_ROWS_MAX, W (K, N), each weight element read
    once; ``ln = (g, b, eps)`` folds the pre-norm LayerNorm of a into the
    staging. The same function as ``linear_plain``. Counts its launches in
    ``linear_rows.launches`` and, per (M, K, N), in ``linear_rows.by_shape``."""
    if not _on_card(a, w, bias, residual, gain, *_ln_tensors(ln)):
        return linear_rows_plain(a, w, bias, act, residual, round_a, drop,
                                 round_out, want_pre, gain, ln)
    return _linear_rows_launch(a, w, bias, act, residual, round_a, drop, round_out,
                               want_pre, gain, ln)


def _linear_rows_launch(a, w, bias, act, residual, round_a, drop, round_out, want_pre,
                        gain, ln):
    M, K, N = _linear_check(a, w, bias, residual, gain, False)
    if act == "swiglu":
        raise ValueError("the few-rows route has no swiglu gate: linear takes it on the "
                         "tensor-core routes at any row count")
    if M > LINEAR_ROWS_MAX:
        raise ValueError(f"the few-rows route takes at most {LINEAR_ROWS_MAX} rows, not {M}")
    g, b, eps = (None, None, 0.0) if ln is None else ln
    if ln is not None:
        if K > LINEAR_ROWS_LN_MAX_K:
            raise ValueError(f"ln folds rows of at most {LINEAR_ROWS_LN_MAX_K}, not {K}")
        _check(g, "ln g", (K,))
        _check(b, "ln b", (K,))
    y = torch.empty((M, N), device=a.device, dtype=torch.float32)
    pre = torch.empty_like(y) if want_pre else None
    _launch(load_library().pd_linear_rows, _ptr(a), _ptr(w),
            int(w.dtype == torch.bfloat16), _ptr(bias), _ptr(gain), _ptr(residual),
            _ptr(y), _ptr(pre), _ptr(g), _ptr(b), float(eps), M, N, K,
            linear_rows_tile(N), int(round_a), _ACT[act],
            *(drop.args() if drop else _NO_DROP), int(round_out), _stream(a))
    linear_rows.launches += 1
    linear_rows.by_shape[(M, K, N)] = linear_rows.by_shape.get((M, K, N), 0) + 1
    return (y, pre) if want_pre else y


linear_rows.launches = 0
linear_rows.by_shape = {}


# ----------------------------------------------------------------- attention
def _heads(qkv, nhead: int, round_in: bool):
    """(B, N, 3D) -> q, k, v (B, H, N, Dh), rounded to bf16 when asked."""
    B, N, D3 = qkv.shape
    q, k, v = qkv.view(B, N, 3, nhead, D3 // 3 // nhead).permute(2, 0, 3, 1, 4)
    if round_in:
        q, k, v = round_bf16(q), round_bf16(k), round_bf16(v)
    return q, k, v


def _softmax_probs(q, k, attn_bias, key_bias):
    s = (q @ k.transpose(-1, -2)) * (1.0 / q.shape[-1]**0.5)
    if attn_bias is not None:
        s = s + attn_bias
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def attention_plain(qkv, nhead: int, attn_bias=None, key_bias=None,
                    round_in: bool = False, drop: Optional[Drop] = None):
    B, N, D3 = qkv.shape
    q, k, v = _heads(qkv, nhead, round_in)
    p = _softmax_probs(q, k, attn_bias, key_bias)
    if drop is not None:
        p = p * dropout_mask(drop, p.shape, p.device)
    if round_in:
        p = round_bf16(p)
    return (p @ v).transpose(1, 2).reshape(B, N, D3 // 3)


# csrc/attention.cu: kMaxDh; the MMA depth needs Dh % 8 == 0.
ATTENTION_MAX_DH = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _head_depth(Dh: int) -> int:
    """The head width the attention kernels pad Dh to: 32, 64 or 128."""
    return 32 if Dh <= 32 else 64 if Dh <= 64 else 128


@functools.cache
def attention_smem_bytes(N: int, Dh: int, round_in: bool) -> int:
    """Dynamic shared memory of one ``attention`` launch (csrc/attention.cu,
    smem_bytes): K and V tiles of up to 64 keys in bf16 mode, 32 in float32
    mode (two stages when N needs more than one tile) and, in float32 mode,
    the block's q rows (16 a warp, up to 4 warps); the head padded to 32, 64
    or 128 columns, rows padded for conflict-free fragment loads. At most
    141,312 B (Dh 128, bf16 mode), under the 232,448 B a block may use."""
    warps = min(4, -(-N // 16))
    tile = 64 if round_in else 32
    kt = tile if N >= tile else _round_up(N, 16)
    stages = 2 if N > kt else 1
    dp = _head_depth(Dh)
    sq, sv = dp + (16 if round_in else 8), dp + 4
    return 4 * ((0 if round_in else 16 * warps * sq) + stages * kt * (sq + sv))


def _attention_check(qkv, nhead, attn_bias, key_bias):
    """Shapes of a packed QKV buffer and its bias -> (B, N, D, Dh, bias, kind)."""
    if attn_bias is not None and key_bias is not None:
        raise ValueError("pass attn_bias or key_bias, not both")
    B, N, D3 = qkv.shape
    D = D3 // 3
    Dh = D // nhead
    if D3 != 3 * D or D != nhead * Dh:
        raise ValueError(f"qkv width {D3} does not split into 3 x {nhead} heads")
    if Dh > ATTENTION_MAX_DH:
        raise ValueError(f"head width {Dh} > {ATTENTION_MAX_DH}")
    _check(qkv, "qkv", (B, N, D3))
    _check(attn_bias, "attn_bias", (N, N))
    _check(key_bias, "key_bias", (B, N))
    bias, kind = (attn_bias, 1) if attn_bias is not None else (
        (key_bias, 2) if key_bias is not None else (None, 0)
    )
    return B, N, D, Dh, bias, kind


def attention(qkv, nhead: int, attn_bias=None, key_bias=None,
              round_in: bool = False, drop: Optional[Drop] = None):
    """Softmax attention of a packed (B, N, 3D) QKV buffer -> (B, N, D).

    ``attn_bias`` (N, N) is shared by every sequence (the ViT's
    block-diagonal scale packing); ``key_bias`` (B, N) masks keys (the
    denoiser's frame mask). Use NEG, not -inf, for a masked entry. ``drop``
    multiplies the normalised p (element ((b H + h) N + i) N + j) by its
    dropout mask before the bf16 rounding and p.V. On the card both products
    run on the tensor cores: bf16 MMAs with ``round_in`` (q, k, v and p are
    bf16 values there), 3xTF32 (float32 accuracy) without."""
    if not _on_card(qkv, attn_bias, key_bias):
        return attention_plain(qkv, nhead, attn_bias, key_bias, round_in, drop)
    B, N, D, Dh, bias, kind = _attention_check(qkv, nhead, attn_bias, key_bias)
    if Dh % 8:
        raise ValueError(f"head width {Dh} is not a multiple of 8 (the MMA depth)")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned (the kernel copies 16-byte chunks)")
    if attention_smem_bytes(N, Dh, bool(round_in)) > _MAX_SMEM:
        raise ValueError(f"attention at N {N}, Dh {Dh} exceeds one block's shared memory")
    out = torch.empty((B, N, D), device=qkv.device, dtype=torch.float32)
    _launch(load_library().pd_attention, _ptr(qkv), _ptr(bias), kind,
            _ptr(out), B, N, nhead, Dh, 1.0 / Dh**0.5, int(round_in),
            *(drop.args() if drop else _NO_DROP), _stream(qkv))
    attention.launches += 1
    return out


attention.launches = 0


# ---------------------------------------------------------- sampler fold-ins
# (csrc/sampler.cu): one cluster kernel, three entries. The prologue starts
# step 0, a boundary launch ends step r and starts step r + 1, the epilogue
# ends the last step.
SAMPLER_CLUSTERS = (16, 8)  # cluster sizes of sampler_step_kernel, first that schedules
SAMPLER_TILE_ROWS = 32  # rows of a tile (csrc/sampler.cu SR)
SAMPLER_SPLIT = 6  # ranges of the prologue's product (KPP)
_SAMPLER_MODES = {"prologue": 0, "epilogue": 1, "boundary": 2}


def sampler_smem_bytes(cluster: int, D: int, HID: int, TD: int, NH: int) -> int:
    """Dynamic shared memory of a sampler block in a cluster of ``cluster``
    (csrc/sampler.cu, SAMPLER_REGIONS, each region rounded up to 128 bytes)."""
    SR, KPP = SAMPLER_TILE_ROWS, SAMPLER_SPLIT
    KS, HH = D // cluster, TD * NH
    PW = 2 * HH + TD
    regions = (KS * HID, HH * KS, HH * KS, TD * KS, SR * KS, PW * SR, max(SR * HID, KPP * SR * KS),
               SR * (HID + 16), SR * KS, KS, SR * TD, SR * TD,
               3 * HID + HID * 12 + TD, 8)  # W1's rows padded to 12 floats
    return 4 * sum(_round_up(n, 32) for n in regions)


@functools.cache
def sampler_cluster_size(D: int, HID: int, TD: int, NH: int) -> int:
    """The cluster the sampler kernel takes at these widths (HID 0 for the
    prologue, NH 0 for the epilogue) on this card: the first of
    ``SAMPLER_CLUSTERS`` that the card schedules
    (cudaOccupancyMaxActiveClusters), or raise."""
    lib = load_library()
    for c in SAMPLER_CLUSTERS:
        if D % (4 * c) or HID % (4 * c) or sampler_smem_bytes(c, D, HID, TD, NH) > _MAX_SMEM:
            continue
        if lib.pd_sampler_max_active_clusters(c, D, HID, TD, NH) > 0:
            return c
    raise ValueError(f"no sampler cluster of {SAMPLER_CLUSTERS} blocks takes D {D}, HID {HID}, "
                     f"T {TD}, F {NH} on this card (D and HID in multiples of 4 x the cluster)")


def _harmonic_args(x, n_harmonics: int):
    """(rows, T) -> (rows, T * F) with column d*F + f = x[d] * 2^f."""
    freqs = 2.0 ** torch.arange(n_harmonics, dtype=x.dtype, device=x.device)
    return (x[:, :, None] * freqs).reshape(x.shape[0], -1)


def _prologue_dims(x, wsin, wcos, wx, zf, tc, step: int):
    rows, TD = x.shape
    HH, D = wsin.shape
    R = tc.shape[0]
    if HH % TD or not 0 <= step < R:
        raise ValueError(f"bad harmonic width {HH} or step {step}")
    _check(x, "x", (rows, TD))
    _check(wsin, "wsin", (HH, D))
    _check(wcos, "wcos", (HH, D))
    _check(wx, "wx", (TD, D))
    _check(zf, "zf", (rows, D))
    _check(tc, "tc", (R, D))
    return rows, D, TD, HH // TD


def _epilogue_dims(h, w0, b0, gh, bh, w1, b1, coef, noise, x, step: int):
    rows, D = h.shape
    HID = w0.shape[1]
    TD = w1.shape[1]
    R = coef.shape[0]
    if not 0 <= step < R:
        raise ValueError(f"step {step} outside [0, {R})")
    _check(h, "h", (rows, D))
    _check(w0, "w0", (D, HID))
    _check(b0, "b0", (HID,))
    _check(gh, "gh", (HID,))
    _check(bh, "bh", (HID,))
    _check(w1, "w1", (HID, TD))
    _check(b1, "b1", (TD,))
    _check(coef, "coef", (R, 2))
    _check(noise, "noise", (R, rows, TD))
    _check(x, "x", (rows, TD))
    return rows, D, HID, TD


def _sampler_step(mode: str, rows, D, HID, TD, NH, step, eps, x, h_out=None,
                  head=(None,) * 9, prologue=(None,) * 5):
    """One launch of sampler_step_kernel; ``head`` is (h, w0, b0, gh, bh, w1,
    b1, coef, noise), ``prologue`` (wsin, wcos, wx, zf, tc). The kernel
    copies its slices with bulk copies: every operand but x, b1, coef and
    the noise must start on a 16-byte boundary."""
    if NH > 24 or TD != 9 or HID > 128:
        raise ValueError(f"the sampler kernel takes T 9, F <= 24 and HID <= 128, not T {TD}, "
                         f"F {NH} and HID {HID}")
    for name, t in zip(("h", "w0", "b0", "gh", "bh", "w1", "wsin", "wcos", "wx", "zf", "tc"),
                       (*head[:6], *prologue)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the sampler kernel")
    cluster = sampler_cluster_size(D, HID, TD, NH)
    _launch(load_library().pd_sampler_step, *[_ptr(t) for t in head],
            *[_ptr(t) for t in prologue], _ptr(x), _ptr(h_out), rows, D, HID, TD, NH,
            step, _SAMPLER_MODES[mode], eps, cluster, _stream(x))


def sampler_prologue_plain(x, wsin, wcos, wx, zf, tc, step: int):
    S = _harmonic_args(x, wsin.shape[0] // x.shape[1])
    return torch.sin(S) @ wsin + torch.cos(S) @ wcos + x @ wx + zf + tc[step]


def sampler_prologue(x, wsin, wcos, wx, zf, tc, step: int):
    """Layer-0 input of reverse step ``step``: (rows, T) state -> (rows, D)."""
    if not _on_card(x, wsin, wcos, wx, zf, tc):
        return sampler_prologue_plain(x, wsin, wcos, wx, zf, tc, step)
    rows, D, TD, NH = _prologue_dims(x, wsin, wcos, wx, zf, tc, step)
    h = torch.empty((rows, D), device=x.device, dtype=torch.float32)
    _sampler_step("prologue", rows, D, 0, TD, NH, step, 0.0, x, h,  # no head: HID 0
                  prologue=(wsin, wcos, wx, zf, tc))
    sampler_prologue.launches += 1
    return h


sampler_prologue.launches = 0


def sampler_epilogue_plain(h, w0, b0, gh, bh, w1, b1, coef, noise, x,
                           step: int, eps: float = 1e-5):
    g = torch.relu(layernorm_plain(h @ w0 + b0, gh, bh, eps))
    e = g @ w1 + b1
    x.copy_(coef[step, 0] * x - coef[step, 1] * e + noise[step])
    return x


def sampler_epilogue(h, w0, b0, gh, bh, w1, b1, coef, noise, x, step: int,
                     eps: float = 1e-5):
    """Head MLP on the trunk output h, then the posterior update of the
    (rows, T) state x IN PLACE: x <- cx x - ce eps + noise[step]."""
    head = (h, w0, b0, gh, bh, w1, b1, coef, noise)
    if not _on_card(*head, x):
        return sampler_epilogue_plain(*head, x, step, eps)
    rows, D, HID, TD = _epilogue_dims(*head, x, step)
    _sampler_step("epilogue", rows, D, HID, TD, 0, step, eps, x, head=head)  # no features
    sampler_epilogue.launches += 1
    return x


sampler_epilogue.launches = 0


def _boundary_step(coef, tc, step: int):
    if not 0 <= step < step + 1 < min(coef.shape[0], tc.shape[0]):
        raise ValueError(f"no step {step + 1} after step {step} of {coef.shape[0]}")


def sampler_boundary_plain(h, w0, b0, gh, bh, w1, b1, coef, noise, x, step: int,
                           wsin, wcos, wx, zf, tc, eps: float = 1e-5):
    _boundary_step(coef, tc, step)
    sampler_epilogue_plain(h, w0, b0, gh, bh, w1, b1, coef, noise, x, step, eps)
    return sampler_prologue_plain(x, wsin, wcos, wx, zf, tc, step + 1)


def sampler_boundary(h, w0, b0, gh, bh, w1, b1, coef, noise, x, step: int,
                     wsin, wcos, wx, zf, tc, eps: float = 1e-5):
    """The epilogue of step ``step`` (x updated IN PLACE), then the prologue
    of step ``step + 1`` on the new x, in ONE launch: returns the next
    step's layer-0 input (rows, D)."""
    head = (h, w0, b0, gh, bh, w1, b1, coef, noise)
    prologue = (wsin, wcos, wx, zf, tc)
    if not _on_card(*head, x, *prologue):
        return sampler_boundary_plain(*head, x, step, *prologue, eps)
    _boundary_step(coef, tc, step)
    rows, D, HID, TD = _epilogue_dims(*head, x, step)
    _, _, _, NH = _prologue_dims(x, *prologue, step + 1)
    if wsin.shape[1] != D:
        raise ValueError(f"the prologue's width {wsin.shape[1]} is not h's {D}")
    h_next = torch.empty((rows, D), device=x.device, dtype=torch.float32)
    _sampler_step("boundary", rows, D, HID, TD, NH, step, eps, x, h_next, head=head,
                  prologue=prologue)
    sampler_boundary.launches += 1
    return h_next


sampler_boundary.launches = 0


# ---------------------------------------------------------------- GGS phases
def sgd_step(x, buf, stopped, g, count, n_frames, lr, momentum, alpha,
             min_matches):
    """Sticky stop, adaptive clip and torch-SGD momentum of one GGS iteration
    (posediffusion_tpu/ops/ggs_kernel.py:65-81); g is normalised."""
    if min_matches > 0:
        stopped = stopped | (count / n_frames < min_matches)
    mask = (g.abs() > 0).to(x.dtype)
    max_norm = alpha * torch.sqrt(((x * mask) ** 2).sum()) / lr
    clip = torch.clamp(max_norm / (torch.sqrt((g * g).sum()) + 1e-6), max=1.0)
    buf_new = momentum * buf + g * clip
    x_new = x - lr * buf_new
    return torch.where(stopped, x, x_new), torch.where(stopped, buf, buf_new), stopped


def ggs_phase_plain(x, t: GGSTables, image_hw, update_R: bool, update_T: bool,
                    update_FL: bool, sampson_max: float, iters: int, lr: float,
                    momentum: float, alpha: float, min_matches: float):
    """One GGS SGD phase as a Python loop over ``loss_and_grad_core``."""
    x, buf = x.clone(), torch.zeros_like(x)
    stopped = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(iters):
        _, count, g = loss_and_grad_core(
            x, t.kp1x, t.kp1y, t.kp2x, t.kp2y, t.valid, t.B1, t.B2, image_hw,
            update_R, update_T, update_FL, sampson_max)
        x, buf, stopped = sgd_step(x, buf, stopped, g, count, x.shape[0], lr,
                                   momentum, alpha, min_matches)
    return x


def ggs_phase_chunked_plain(x, t: GGSTables, image_hw, update_R: bool,
                            update_T: bool, update_FL: bool, sampson_max: float,
                            iters: int, lr: float, momentum: float, alpha: float,
                            min_matches: float, chunk: int):
    """The chunked phase: unnormalised gradients summed over the pair chunks,
    then divided by the global count. The backward is linear in the upstream
    adjoint, so the sum over chunks is the unnormalised gradient of the whole
    (padded) table, which this takes in one call per iteration."""
    if t.valid.shape[0] % chunk:
        raise ValueError(f"{t.valid.shape[0]} pairs do not split into chunks of {chunk}")
    x, buf = x.clone(), torch.zeros_like(x)
    stopped = torch.zeros((), dtype=torch.bool, device=x.device)
    for _ in range(iters):
        _, count, g = loss_and_grad_core(
            x, t.kp1x, t.kp1y, t.kp2x, t.kp2y, t.valid, t.B1, t.B2, image_hw,
            update_R, update_T, update_FL, sampson_max, normalize=False)
        x, buf, stopped = sgd_step(x, buf, stopped, g / count.clamp_min(1.0), count,
                                   x.shape[0], lr, momentum, alpha, min_matches)
    return x


def _ggs_check(x, t: GGSTables):
    N = x.shape[0]
    P, Q = t.valid.shape
    _check(x, "x", (N, 9))
    for name in ("kp1x", "kp1y", "kp2x", "kp2y", "valid"):
        _check(getattr(t, name), name, (P, Q))
    _check(t.pi1, "pi1", (P,), (torch.int32,))
    _check(t.pi2, "pi2", (P,), (torch.int32,))
    _check(t.fptr, "fptr", (N + 1,), (torch.int32,))
    _check(t.fent, "fent", (2 * P,), (torch.int32,))
    return N, P, Q


def _ggs_args(x, out, t, N, P, Q, image_hw, update_R, update_T, update_FL,
              sampson_max, iters, lr, momentum, alpha, min_matches):
    h, w = image_hw
    return (_ptr(x), _ptr(out), _ptr(t.kp1x), _ptr(t.kp1y), _ptr(t.kp2x),
            _ptr(t.kp2y), _ptr(t.valid), _ptr(t.pi1), _ptr(t.pi2), _ptr(t.fptr),
            _ptr(t.fent), N, P, Q, int(h), int(w), int(update_R), int(update_T),
            int(update_FL), float(sampson_max), int(iters), float(lr),
            float(momentum), float(alpha), float(min_matches))


GGS_MAX_WARPS = 12  # a warp per pair of the block, at most 12 (csrc/ggs.cu)
GGS_CLUSTERS = (16, 8)  # cluster sizes of ggs_phase_chunked, first that schedules


def ggs_warps(pairs: int) -> int:
    """Warps of a GGS block that owns ``pairs`` pairs."""
    return min(pairs, GGS_MAX_WARPS)


def ggs_table_resident(N: int, pairs: int, total_pairs: int, Q: int) -> bool:
    """Whether a GGS block's slice of the table (five planes of ``pairs`` x
    ``Q`` floats) fits in its shared memory beside the rest
    (csrc/ggs.cu, ggs_resident)."""
    return 4 * (_ggs_base_floats(N, pairs, total_pairs) + 5 * pairs * Q) <= _MAX_SMEM


def _ggs_base_floats(N: int, pairs: int, total_pairs: int) -> int:
    # every pair's row (24 floats, and 5 more stored by column), x, momentum,
    # gradient (N x 9 each), poses (N x 12), the norms' shares (N x 2), the
    # stop flag, the block's pair frames, fptr and fent (int32), rounded up
    # to 16 bytes (csrc/ggs.cu, ggs_base_floats)
    n = 29 * total_pairs + 41 * N + 1 + 2 * pairs + N + 1 + 2 * total_pairs
    return _round_up(n, 4)


def ggs_smem_bytes(N: int, pairs: int, total_pairs: int, Q: int) -> int:
    """Dynamic shared memory of a GGS block that owns ``pairs`` of the
    ``total_pairs`` pairs of Q padded matches (csrc/ggs.cu, ggs_smem_bytes):
    the table slice included when resident. 20 frames at 12 pairs a block:
    27,280 B, plus the slice's 30,720 at 128 matches; at 1,024 the slice
    stays in global memory."""
    table = 5 * pairs * Q if ggs_table_resident(N, pairs, total_pairs, Q) else 0
    return 4 * (_ggs_base_floats(N, pairs, total_pairs) + table)


@functools.cache
def ggs_cluster_size(N: int, P: int, Q: int) -> int:
    """The cluster ``ggs_phase_chunked`` takes for P pairs of N frames on
    this card: the first of ``GGS_CLUSTERS`` that the card schedules
    (cudaOccupancyMaxActiveClusters), or raise."""
    lib = load_library()
    for c in GGS_CLUSTERS:
        pairs = -(-P // c)
        if ggs_smem_bytes(N, pairs, c * pairs, Q) > _MAX_SMEM:
            continue
        if lib.pd_ggs_max_active_clusters(N, pairs, Q, c) > 0:
            return c
    raise RuntimeError(f"no GGS cluster of {GGS_CLUSTERS} blocks over {P} pairs of "
                       f"{N} frames ({Q} matches a pair) can be scheduled on this card")


def ggs_phase(x, t: GGSTables, image_hw, update_R: bool, update_T: bool,
              update_FL: bool, sampson_max: float, iters: int, lr: float,
              momentum: float, alpha: float, min_matches: float):
    """All ``iters`` iterations of one GGS phase in ONE launch of one block
    (csrc/ggs.cu, a cluster of one): x (N, 9) -> the updated x."""
    if not _on_card(x, t.valid):
        return ggs_phase_plain(x, t, image_hw, update_R, update_T, update_FL,
                               sampson_max, iters, lr, momentum, alpha, min_matches)
    N, P, Q = _ggs_check(x, t)
    if ggs_smem_bytes(N, P, P, Q) > _MAX_SMEM:
        raise ValueError(f"{P} pairs of {N} frames exceed one block's shared "
                         "memory: use ggs_phase_chunked")
    out = torch.empty_like(x)
    _launch(load_library().pd_ggs_phase,
            *_ggs_args(x, out, t, N, P, Q, image_hw, update_R, update_T,
                       update_FL, sampson_max, iters, lr, momentum, alpha,
                       min_matches), _stream(x))
    ggs_phase.launches += 1
    return out


ggs_phase.launches = 0


def ggs_phase_chunked(x, t: GGSTables, image_hw, update_R: bool, update_T: bool,
                      update_FL: bool, sampson_max: float, iters: int, lr: float,
                      momentum: float, alpha: float, min_matches: float,
                      chunk: int):
    """The same phase in ONE launch of a thread-block cluster of P / ``chunk``
    blocks (at most 16), ``chunk`` pairs each (csrc/ggs.cu). The pair count
    must be a multiple of ``chunk`` (pad_grouped_pairs);
    ``ggs_phase_chunked.cluster`` holds the last launch's cluster size."""
    if not _on_card(x, t.valid):
        return ggs_phase_chunked_plain(x, t, image_hw, update_R, update_T,
                                       update_FL, sampson_max, iters, lr,
                                       momentum, alpha, min_matches, chunk)
    N, P, Q = _ggs_check(x, t)
    if chunk < 1 or P % chunk or P // chunk > GGS_CLUSTERS[0]:
        raise ValueError(f"{P} pairs do not split into at most {GGS_CLUSTERS[0]} "
                         f"blocks of {chunk}")
    if ggs_smem_bytes(N, chunk, P, Q) > _MAX_SMEM:
        raise ValueError(f"{chunk} pairs of {N} frames exceed one block's shared memory")
    out = torch.empty_like(x)
    _launch(load_library().pd_ggs_phase_chunked,
            *_ggs_args(x, out, t, N, P, Q, image_hw, update_R, update_T,
                       update_FL, sampson_max, iters, lr, momentum, alpha,
                       min_matches), chunk, _stream(x))
    ggs_phase_chunked.launches += 1
    ggs_phase_chunked.cluster = P // chunk
    return out


ggs_phase_chunked.cluster = 0
ggs_phase_chunked.launches = 0


# ------------------------------------------------ SuperGlue's final step
# (csrc/superglue.cu). Masks are (C, K) float32 0/1; the coupling and the
# log assignment Z are (C, K + 1, K + 1) with the dustbin at row/column K.
SG_NEG = -1e9  # a masked coupling cell, as the JAX package's _NEG
SG_DEAD = -3e38  # outside the live block in match extraction
SG_TILE = 128  # keypoints a side of a scores tile (csrc/superglue.cu SC_BM, SC_BN)


def sg_scores_scratch(C: int, K: int) -> int:
    """int32 scratch of the scores for C pairs of K keypoints, as
    csrc/superglue.cu pd_sg_scores_scratch counts it: the tile flags (C, 2,
    n), the tile list (C n^2) and its live count, n = ceil(K / SG_TILE)."""
    n = -(-K // SG_TILE)
    return 2 * C * n + C * n * n + 1


def superglue_coupling_plain(m, mask0, mask1, bin_score):
    """m (C, 2, K, D) final projections of both sets -> (coupling, log_mu,
    log_nu (C, K + 1), norm (C,)), as ``matching.superglue.log_sinkhorn``
    builds them."""
    C, _, K, D = m.shape
    v0, v1 = mask0 > 0.5, mask1 > 0.5
    b = bin_score.reshape(())
    s = (m[:, 0] @ m[:, 1].transpose(1, 2)) / D**0.5
    cpl = torch.empty((C, K + 1, K + 1), dtype=torch.float32, device=m.device)
    cpl[:, :K, :K] = torch.where(v0[:, :, None] & v1[:, None, :], s, SG_NEG)
    cpl[:, :K, K] = torch.where(v0, b, SG_NEG)
    cpl[:, K, :K] = torch.where(v1, b, SG_NEG)
    cpl[:, K, K] = b
    ms, ns = v0.sum(1).float(), v1.sum(1).float()
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([torch.where(v0, norm[:, None], SG_NEG), (torch.log(ns) + norm)[:, None]], 1)
    log_nu = torch.cat([torch.where(v1, norm[:, None], SG_NEG), (torch.log(ms) + norm)[:, None]], 1)
    return cpl, log_mu, log_nu, norm


def superglue_coupling(m, mask0, mask1, bin_score):
    """Pair scores m0 m1^T / sqrt(D), masked, with the dustbin row and column
    and the Sinkhorn marginals. bin_score is a (1,) float32 tensor. On the
    card the scores run as 3xTF32 tensor-core products (about 2^-21
    relative a product) in tiles of SG_TILE x SG_TILE, those with no valid
    row or no valid column skipped; masked cells are -1e9 exactly."""
    if not _on_card(m, mask0, mask1, bin_score):
        return superglue_coupling_plain(m, mask0, mask1, bin_score)
    C, two, K, D = m.shape
    _check(m, "m", (C, 2, K, D))
    _check(mask0, "mask0", (C, K))
    _check(mask1, "mask1", (C, K))
    _check(bin_score, "bin_score", (1,))
    f32 = dict(device=m.device, dtype=torch.float32)
    cpl = torch.empty((C, K + 1, K + 1), **f32)
    log_mu = torch.empty((C, K + 1), **f32)
    log_nu = torch.empty((C, K + 1), **f32)
    norm = torch.empty((C,), **f32)
    scratch = torch.empty((sg_scores_scratch(C, K),), device=m.device, dtype=torch.int32)
    _launch(load_library().pd_sg_coupling, _ptr(m), _ptr(mask0), _ptr(mask1),
            _ptr(bin_score), _ptr(cpl), _ptr(log_mu), _ptr(log_nu), _ptr(norm),
            _ptr(scratch), C, K, D, float(D**0.5), _stream(m))
    superglue_coupling.launches += 1
    return cpl, log_mu, log_nu, norm


superglue_coupling.launches = 0


def superglue_sinkhorn_plain(cpl, log_mu, log_nu, norm, iters: int):
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(cpl + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(cpl + u[:, :, None], dim=1)
    return cpl + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def superglue_sinkhorn(cpl, log_mu, log_nu, norm, iters: int):
    """``iters`` log-domain Sinkhorn iterations (row then column log-sum-exp)
    from zero potentials -> the log assignment Z = cpl + u + v - norm."""
    if not _on_card(cpl, log_mu, log_nu, norm):
        return superglue_sinkhorn_plain(cpl, log_mu, log_nu, norm, iters)
    C, K1, _ = cpl.shape
    _check(cpl, "cpl", (C, K1, K1))
    _check(log_mu, "log_mu", (C, K1))
    _check(log_nu, "log_nu", (C, K1))
    _check(norm, "norm", (C,))
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    Z = torch.empty_like(cpl)
    _launch(load_library().pd_sg_sinkhorn, _ptr(cpl), _ptr(log_mu), _ptr(log_nu),
            _ptr(norm), _ptr(u), _ptr(v), _ptr(Z), C, K1, int(iters), _stream(cpl))
    superglue_sinkhorn.launches += 1
    return Z


superglue_sinkhorn.launches = 0


def superglue_matches_plain(Z, mask0, mask1, threshold: float):
    K = mask0.shape[1]
    live = (mask0 > 0.5)[:, :, None] & (mask1 > 0.5)[:, None, :]
    z = torch.where(live, Z[:, :K, :K], SG_DEAD)
    rowmax = z.amax(2)
    idx0 = z.argmax(2)  # first maximum of each row
    idx1 = z.argmax(1)  # first maximum of each column
    rows = torch.arange(K, device=Z.device)
    mutual = (idx1.gather(1, idx0) == rows) & live.gather(2, idx0[..., None])[..., 0]
    score = torch.where(mutual, torch.exp(rowmax), 0.0)
    ok = mutual & (score > threshold)
    return torch.where(ok, idx0, -1).to(torch.int32), torch.where(ok, score, 0.0)


def superglue_matches(Z, mask0, mask1, threshold: float):
    """Mutual-max matches of the log assignment's keypoint block, first
    index on ties: (matches0 (C, K) int32 column or -1, mscores0 (C, K)
    float32)."""
    if not _on_card(Z, mask0, mask1):
        return superglue_matches_plain(Z, mask0, mask1, threshold)
    C, K = mask0.shape
    _check(Z, "Z", (C, K + 1, K + 1))
    _check(mask0, "mask0", (C, K))
    _check(mask1, "mask1", (C, K))
    colarg = torch.empty((C, K), device=Z.device, dtype=torch.int32)
    matches = torch.empty((C, K), device=Z.device, dtype=torch.int32)
    mscores = torch.empty((C, K), device=Z.device, dtype=torch.float32)
    _launch(load_library().pd_sg_matches, _ptr(Z), _ptr(mask0), _ptr(mask1),
            _ptr(colarg), _ptr(matches), _ptr(mscores), C, K, float(threshold),
            _stream(Z))
    superglue_matches.launches += 1
    return matches, mscores


superglue_matches.launches = 0


# ----------------------------------------------- the train trunks' backward
# (posediffusion_tpu/ops/vit_train_kernel.py _bwd_call). Weight gradients are
# float32 partials over row ranges, summed in order by a second pass
# (csrc/train.cu, pd_sum_partials), as the TPU kernel sums its per-chunk
# partials (:937-940): deterministic, no atomics.
def attention_bwd_plain(qkv, dout, nhead: int, attn_bias=None, key_bias=None,
                        round_in: bool = False, drop: Optional[Drop] = None):
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = _heads(qkv, nhead, round_in)
    do = dout.view(B, N, nhead, D // nhead).transpose(1, 2)
    if round_in:
        do = round_bf16(do)
    p = _softmax_probs(q, k, attn_bias, key_bias)
    mask = dropout_mask(drop, p.shape, p.device)
    p_d = p if mask is None else p * mask
    rnd = round_bf16 if round_in else (lambda t: t)
    dv = rnd(p_d).transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    if mask is not None:
        dp = dp * mask
    ds = rnd(p * (dp - (dp * p).sum(-1, keepdim=True)) * (1.0 / q.shape[-1]**0.5))
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    return torch.cat([t.transpose(1, 2).reshape(B, N, D) for t in (dq, dk, dv)], -1)


@functools.cache
def attention_bwd_smem_bytes(N: int, Dh: int) -> int:
    """Dynamic shared memory of the larger of ``attention_bwd``'s two
    launches, the dk/dv kernel's (csrc/attention_bwd.cu, smem_bytes): the
    block's 16 rows a warp (up to 4 warps) of k and v, two stages (one when
    a tile holds all N) of 32 streamed queries (16 for heads of 128) with
    their dout rows and 3 statistics each; rows of the head padded to 32, 64
    or 128 columns plus 8. The same in both modes; at most 104,832 B (Dh
    128), under the 232,448 B a block may use."""
    dp = _head_depth(Dh)
    tile = 16 if dp > 64 else 32
    warps = min(4, -(-N // 16))
    ct = tile if N >= tile else _round_up(N, 16)
    stages = 2 if N > ct else 1
    sq = dp + 8
    return 4 * (2 * 16 * warps * sq + 2 * stages * ct * sq + 3 * stages * ct)


def attention_bwd(qkv, dout, nhead: int, attn_bias=None, key_bias=None,
                  round_in: bool = False, drop: Optional[Drop] = None):
    """Cotangent of ``attention``'s packed input: (B, N, 3D) dq | dk | dv
    from its output cotangent ``dout`` (B, N, D), with the forward's bias,
    rounding and dropout (csrc/attention_bwd.cu). On the card every product
    runs on the tensor cores: bf16 MMAs with ``round_in``, 3xTF32 without."""
    if not _on_card(qkv, dout, attn_bias, key_bias):
        return attention_bwd_plain(qkv, dout, nhead, attn_bias, key_bias,
                                   round_in, drop)
    B, N, D, Dh, bias, kind = _attention_check(qkv, nhead, attn_bias, key_bias)
    _check(dout, "dout", (B, N, D))
    if Dh % 8:
        raise ValueError(f"head width {Dh} is not a multiple of 8 (the MMA depth)")
    if qkv.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("qkv and dout must be 16-byte aligned "
                         "(the kernels copy 16-byte chunks)")
    if attention_bwd_smem_bytes(N, Dh) > _MAX_SMEM:
        raise ValueError(f"attention_bwd at N {N}, Dh {Dh} exceeds one block's shared memory")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((B * nhead * N * 3,), device=qkv.device, dtype=torch.float32)
    _launch(load_library().pd_attention_bwd, _ptr(qkv), _ptr(dout), _ptr(bias),
            kind, _ptr(dqkv), _ptr(stats), B, N, nhead, Dh, 1.0 / Dh**0.5,
            int(round_in), *(drop.args() if drop else _NO_DROP), _stream(qkv))
    attention_bwd.launches += 1
    return dqkv


attention_bwd.launches = 0


def _sum_partials(part: torch.Tensor) -> torch.Tensor:
    """(S, ...) float32 partials -> their sum over S, in order. A helper of
    ``linear_wgrad`` and ``layerscale_bwd``, not a wrapper of
    ``launch_counts``: ``_sum_partials.launches`` counts its launches apart."""
    out = torch.empty(part.shape[1:], device=part.device, dtype=torch.float32)
    _launch(load_library().pd_sum_partials, _ptr(part), _ptr(out), part.shape[0],
            out.numel(), _stream(part))
    _sum_partials.launches += 1
    return out


_sum_partials.launches = 0


def layernorm_bwd_plain(x, g, dh, eps: float, residual=None,
                        round_out: bool = False):
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (x - mean) * rstd
    dxhat = dh * g
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    if residual is not None:
        dx = dx + residual
    if round_out:
        dx = round_bf16(dx)
    return dx, (dh * xhat).sum(0), dh.sum(0)


# csrc/layernorm.cu: LNB_MAX_D, 32 columns of a row in each lane's
# registers (LNB_WIDE_MAX_D, ViT-g/14's 1,536, past that: 48 columns a lane,
# the dg / db sums in shared memory); the grid is at most LNB_BLOCKS blocks of LNB_WARPS warps
# (two blocks on each of the H100's SMs), one dg / db partial each, whatever
# the rows: a warp walks rows blocks x 8 apart.
LAYERNORM_BWD_MAX_D = 1536
LAYERNORM_BWD_WARPS = 8
LAYERNORM_BWD_MAX_BLOCKS = 2 * _SMS


def layernorm_bwd_blocks(rows: int) -> int:
    """Blocks (and dg / db partials) of ``layernorm_bwd`` over ``rows`` rows:
    one row a warp while that gives fewer than LAYERNORM_BWD_MAX_BLOCKS."""
    return max(1, min(-(-rows // LAYERNORM_BWD_WARPS), LAYERNORM_BWD_MAX_BLOCKS))


def layernorm_bwd(x, g, dh, eps: float, residual=None, round_out: bool = False):
    """Backward of ``layernorm`` on (rows, D) from its saved input x and the
    output cotangent dh: (dx [+ residual], dg, db). x-hat and rstd are
    recomputed from x, as ``_ln_bwd`` does from ``_ln_fwd``. On the card dg
    and db are summed from per-block partials in a fixed order (no atomics:
    they repeat bitwise)."""
    if not _on_card(x, g, dh, residual):
        return layernorm_bwd_plain(x, g, dh, eps, residual, round_out)
    rows, D = x.shape
    _check(x, "x", (rows, D))
    _check(g, "g", (D,))
    _check(dh, "dh", (rows, D))
    _check(residual, "residual", (rows, D))
    if D > LAYERNORM_BWD_MAX_D:
        raise ValueError(f"layernorm_bwd: D {D} > {LAYERNORM_BWD_MAX_D}")
    dx = torch.empty_like(x)
    part = torch.empty((layernorm_bwd_blocks(rows), 2, D), device=x.device,
                       dtype=torch.float32)
    dgb = torch.empty((2, D), device=x.device, dtype=torch.float32)
    _launch(load_library().pd_layernorm_bwd, _ptr(x), _ptr(g), _ptr(dh), _ptr(residual),
            _ptr(dx), _ptr(part), _ptr(dgb), rows, D, eps, int(round_out), _stream(x))
    layernorm_bwd.launches += 1
    return dx, dgb[0], dgb[1]


layernorm_bwd.launches = 0


def linear_wgrad_plain(x, dy, round_in: bool = False):
    xr, dyr = (round_bf16(x), round_bf16(dy)) if round_in else (x, dy)
    return xr.t() @ dyr, dy.sum(0)


# Row split of the weight gradient (csrc/linear.cu pd_linear_wgrad; bf16
# mode csrc/wgrad.cu): one block per (split, dW tile), each split at least
# _WGRAD_MIN_ROWS rows. Every route takes a 128 x 128 tile, one block an SM
# (the accumulators take most of the registers, the wgmma tiles' rings most
# of the shared memory), so a call takes about waves x (rows of a split + a
# block's fixed cost, _WGRAD_BLOCK_ROWS rows' worth): the split is the
# cheapest by that count among those with at least one block per SM (fc1 at
# 135,168 rows: 11 splits, 396 blocks, three whole waves).
WGRAD_TILE = {False: 128, True: 128}
_WGRAD_MIN_ROWS = 1024
_WGRAD_BLOCK_ROWS = 512


def wgrad_rows(M: int, K: int, N: int, round_in: bool = False) -> int:
    """Rows per split of ``linear_wgrad`` for an (M, K) x (M, N) product."""
    tile = WGRAD_TILE[bool(round_in)]
    tiles = -(-K // tile) * -(-N // tile)
    s_max = -(-M // _WGRAD_MIN_ROWS)
    lo = min(s_max, -(-_SMS // tiles))
    splits = min(range(lo, s_max + 1), key=lambda S: (
        -(-tiles * S // _SMS) * (-(-M // S) + _WGRAD_BLOCK_ROWS), S))
    return -(-M // splits)


def linear_wgrad(x, dy, round_in: bool = False):
    """Weight and bias gradients of ``y = x @ W + b``: (x^T dy (K, N),
    colsum(dy) (N,)), float32. On the card the product runs on the tensor
    cores, on the route csrc/linear.cu wgrad_route takes for the operands
    (``pd_linear_wgrad_route`` returns it):

    * ``tf32_wgmma``: float32 x and dy on 16-byte boundaries with K and N
      multiples of 4 (rows TMA can address): 3xTF32 on TF32 ``wgmma``
      (wgrad_tf32_wgmma_kernel: x^T split in registers, dy transposed into
      its K-major TF32 halves inside the tile; about 2^-21 relative a
      product, each 64 rows summed apart). Every float32 train-trunk weight
      gradient takes it.
    * ``tf32_mma``: other float32 operands (K or N off 4, a base off 16
      bytes): 3xTF32 ``mma.sync`` (wgrad_tf32_kernel, each 32 rows summed
      apart).
    * ``bf16_wgmma``: ``round_in``, both operands rounded to bf16 (the bf16
      mode) on bf16 ``wgmma``, every product exact and each 64 rows summed
      apart.

    The bias gradient sums the unrounded dy, as the TPU kernel does. Counts
    its launches in ``linear_wgrad.launches``, per (M, K, N) in
    ``linear_wgrad.by_shape`` and per route in ``linear_wgrad.by_route``."""
    if not _on_card(x, dy):
        return linear_wgrad_plain(x, dy, round_in)
    M, K = x.shape
    N = dy.shape[1]
    _check(x, "x", (M, K))
    _check(dy, "dy", (M, N))
    rows = wgrad_rows(M, K, N, round_in)
    S = -(-M // rows)
    pw = torch.empty((S, K, N), device=x.device, dtype=torch.float32)
    pb = torch.empty((S, N), device=x.device, dtype=torch.float32)
    lib = load_library()
    route = LINEAR_ROUTES[lib.pd_linear_wgrad_route(
        K, N, int(round_in), int(x.data_ptr() % 16 == 0), int(dy.data_ptr() % 16 == 0))]
    _launch(lib.pd_linear_wgrad, _ptr(x), _ptr(dy), _ptr(pw), _ptr(pb),
            M, K, N, rows, int(round_in), _stream(x))
    linear_wgrad.launches += 1
    linear_wgrad.by_shape[(M, K, N)] = linear_wgrad.by_shape.get((M, K, N), 0) + 1
    linear_wgrad.by_route[route] = linear_wgrad.by_route.get(route, 0) + 1
    return _sum_partials(pw), _sum_partials(pb)


linear_wgrad.by_shape = {}
linear_wgrad.by_route = {}
linear_wgrad.launches = 0


def act_dropout_bwd_plain(dh, a, act: str, drop: Optional[Drop] = None):
    out = dh if drop is None else dh * dropout_mask(drop, dh.shape, dh.device)
    if act == "relu":
        return torch.where(a > 0, out, 0.0)
    if act == "gelu":  # d/da a Phi(a) = Phi(a) + a phi(a), exact erf
        cdf = 0.5 * (1.0 + torch.erf(a * (2.0**-0.5)))
        return out * (cdf + a * torch.exp(-0.5 * a * a) * (2.0 * math.pi) ** -0.5)
    if act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return out


ACT_DROPOUT_BWD_MAX = 1 << 31  # csrc/train.cu: 32-bit element indices


def act_dropout_bwd(dh, a, act: str, drop: Optional[Drop] = None):
    """Cotangent of ``drop(act(a))``: dh times the mask times act'(a), one
    elementwise pass. ``a`` (the pre-activation) may be None for act none.
    On the card a 128-bit streaming pass; operands off a 16-byte boundary
    (a view into a larger buffer) take the kernel's scalar instance. Counts
    its launches in ``act_dropout_bwd.launches`` and, per (shape, act), in
    ``act_dropout_bwd.by_shape``."""
    if not _on_card(dh, a):
        return act_dropout_bwd_plain(dh, a, act, drop)
    _check(dh, "dh", tuple(dh.shape))
    if act != "none":
        _check(a, "a", tuple(dh.shape))
    if dh.numel() >= ACT_DROPOUT_BWD_MAX:
        raise ValueError(f"act_dropout_bwd: {dh.numel()} elements, at most "
                         f"{ACT_DROPOUT_BWD_MAX - 1} (32-bit indices)")
    out = torch.empty_like(dh)
    _launch(load_library().pd_act_dropout_bwd, _ptr(dh),
            _ptr(a if act != "none" else None), _ptr(out), dh.numel(), _ACT[act],
            *(drop.args() if drop else _NO_DROP), _stream(dh))
    act_dropout_bwd.launches += 1
    key = (tuple(dh.shape), act)
    act_dropout_bwd.by_shape[key] = act_dropout_bwd.by_shape.get(key, 0) + 1
    return out


act_dropout_bwd.by_shape = {}
act_dropout_bwd.launches = 0


def layerscale_bwd_plain(dy, o_pre, gamma, drop: Optional[Drop] = None):
    do = dy if drop is None else dy * dropout_mask(drop, dy.shape, dy.device)
    return do * gamma, (do * o_pre).sum(0)


# Rows per block of ``layerscale_bwd``: enough blocks to fill the card four
# times, each at least this many rows.
_LS_MIN_ROWS = 64
_LS_TARGET_BLOCKS = 4 * _SMS
LAYERSCALE_MAX_D = 1536  # csrc/train.cu: ViT-g/14's D; a thread per column, at most 1,024 a block


def layerscale_rows(M: int) -> int:
    blocks = max(1, min(-(-M // _LS_MIN_ROWS), _LS_TARGET_BLOCKS))
    return -(-M // blocks)


def layerscale_bwd(dy, o_pre, gamma, drop: Optional[Drop] = None):
    """Backward of DINOv2's LayerScale after a product and before the
    site's dropout, ``y = drop(o_pre * gamma)``: from the cotangent dy (M, D)
    and the saved pre-gain output o_pre (M, D) -> (dy * mask * gamma,
    dgamma = sum over rows of dy * mask * o_pre), float32. dgamma is summed
    from per-block partials in order (no atomics)."""
    if not _on_card(dy, o_pre, gamma):
        return layerscale_bwd_plain(dy, o_pre, gamma, drop)
    M, D = dy.shape
    _check(dy, "dy", (M, D))
    _check(o_pre, "o_pre", (M, D))
    _check(gamma, "gamma", (D,))
    if D > LAYERSCALE_MAX_D:
        raise ValueError(f"layerscale_bwd: D {D} > {LAYERSCALE_MAX_D}")
    rows = layerscale_rows(M)
    out = torch.empty_like(dy)
    part = torch.empty((-(-M // rows), D), device=dy.device, dtype=torch.float32)
    _launch(load_library().pd_layerscale_bwd, _ptr(dy), _ptr(o_pre), _ptr(gamma),
            _ptr(out), _ptr(part), M, D, rows, *(drop.args() if drop else _NO_DROP),
            _stream(dy))
    layerscale_bwd.launches += 1
    return out, _sum_partials(part)


layerscale_bwd.launches = 0


def swiglu_bwd_plain(dh, pre):
    """(dx1, dx2) = (dh x2 silu'(x1), dh silu(x1)), interleaved as ``pre``
    is, with silu'(x) = s (1 + x (1 - s)), s = 1 / (1 + exp(-x))."""
    x1, x2 = pre[..., 0::2], pre[..., 1::2]
    s = 1.0 / (1.0 + torch.exp(-x1))
    out = torch.empty_like(pre)
    out[..., 0::2] = dh * x2 * (s * (1.0 + x1 * (1.0 - s)))
    out[..., 1::2] = dh * (x1 * s)
    return out


SWIGLU_BWD_MAX = 1 << 31  # csrc/train.cu: 32-bit indices of the hidden elements


def swiglu_bwd(dh, pre):
    """Backward of the gate of ``linear(..., act="swiglu")``: from the
    cotangent dh (M, H) of its output and the pre-activation ``pre`` (M, 2H)
    (x1, x2 of hidden column j at columns 2j, 2j + 1) -> the cotangent of
    ``pre``, the same layout. One pass over dh, pre and the result (20 bytes
    a hidden element; csrc/train.cu swiglu_bwd_kernel). Counts its launches
    in ``swiglu_bwd.launches``."""
    if not _on_card(dh, pre):
        return swiglu_bwd_plain(dh, pre)
    M, H = dh.shape
    _check(dh, "dh", (M, H))
    _check(pre, "pre", (M, 2 * H))
    if dh.numel() >= SWIGLU_BWD_MAX:
        raise ValueError(f"swiglu_bwd: {dh.numel()} hidden elements, at most "
                         f"{SWIGLU_BWD_MAX - 1} (32-bit indices)")
    out = torch.empty_like(pre)
    _launch(load_library().pd_swiglu_bwd, _ptr(dh), _ptr(pre), _ptr(out), dh.numel(),
            _stream(dh))
    swiglu_bwd.launches += 1
    return out


swiglu_bwd.launches = 0


# ------------------------------------------------------------------- tables
KERNELS = SimpleNamespace(
    layernorm=layernorm, linear=linear, linear_rows=linear_rows, attention=attention,
    sampler_prologue=sampler_prologue, sampler_epilogue=sampler_epilogue,
    sampler_boundary=sampler_boundary,
    ggs_phase=ggs_phase, ggs_phase_chunked=ggs_phase_chunked,
    superglue_coupling=superglue_coupling, superglue_sinkhorn=superglue_sinkhorn,
    superglue_matches=superglue_matches,
    attention_bwd=attention_bwd, layernorm_bwd=layernorm_bwd,
    linear_wgrad=linear_wgrad, act_dropout_bwd=act_dropout_bwd,
    layerscale_bwd=layerscale_bwd, swiglu_bwd=swiglu_bwd,
)
PLAIN = SimpleNamespace(
    layernorm=layernorm_plain, linear=linear_plain, linear_rows=linear_rows_plain,
    attention=attention_plain,
    sampler_prologue=sampler_prologue_plain,
    sampler_epilogue=sampler_epilogue_plain,
    sampler_boundary=sampler_boundary_plain,
    ggs_phase=ggs_phase_plain, ggs_phase_chunked=ggs_phase_chunked_plain,
    superglue_coupling=superglue_coupling_plain,
    superglue_sinkhorn=superglue_sinkhorn_plain,
    superglue_matches=superglue_matches_plain,
    attention_bwd=attention_bwd_plain, layernorm_bwd=layernorm_bwd_plain,
    linear_wgrad=linear_wgrad_plain, act_dropout_bwd=act_dropout_bwd_plain,
    layerscale_bwd=layerscale_bwd_plain, swiglu_bwd=swiglu_bwd_plain,
)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in vars(KERNELS).items()}


def reset_launch_counts() -> None:
    for fn in vars(KERNELS).values():
        fn.launches = 0
    _sum_partials.launches = 0
    layernorm.by_shape.clear()
    linear.by_shape.clear()
    linear.by_route.clear()
    linear_rows.by_shape.clear()
    linear_wgrad.by_shape.clear()
    linear_wgrad.by_route.clear()
    act_dropout_bwd.by_shape.clear()
