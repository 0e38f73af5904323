"""The hand-written Hopper kernels, their plain PyTorch versions, and routing.

Five kernels (sources in ``posediffusion_tpu_torch/csrc``) carry the two TPU
kernels of the no-GGS inference path:

=================  ===========================================================
``layernorm``      row LayerNorm, eps and bf16 output rounding as arguments
``linear``         ``epi(a @ W + b) [+ residual]``, W float32 or bfloat16
``attention``      softmax attention over a packed (B, N, 3D) QKV buffer
``sampler_prologue``  layer-0 fold-in of the fused sampler
``sampler_epilogue``  head MLP + posterior update of the fused sampler
=================  ===========================================================

Routing is by the tensors' device and nothing else: on a CUDA tensor a
wrapper launches its kernel (or raises), on a CPU tensor it calls the plain
version beside it. Each plain version computes the same math with the same
bf16 rounding sites and weight dtypes; the CPU tests hold it against the JAX
package and ``chip_smoke.py`` holds each kernel against it on the card.

The kernels are compiled with ``nvcc`` into one shared library at first use
(``build/kernels/``, keyed by a hash of the sources) and bound with ctypes.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
NEG = -1e30  # additive bias of a masked key (never -inf: no row gives NaN)

_ACT = {"none": 0, "relu": 1, "gelu": 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pd_layernorm": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "pd_linear": [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pd_attention": [_P, _P, _I, _P, _I, _I, _I, _I, _F, _I, _P],
    "pd_sampler_prologue": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "pd_sampler_epilogue": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
    ],
}


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


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library, unless the build
    for these exact sources exists already."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
           *[str(s) for s in sorted(_CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
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


# ----------------------------------------------------------------- layernorm
def layernorm_plain(x, g, b, eps: float, round_out: bool = False):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps) * g + b
    return round_bf16(y) if round_out else y


def layernorm(x, g, b, eps: float, round_out: bool = False):
    """LayerNorm over the last axis of a float32 (rows, D) tensor."""
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
    return y


layernorm.launches = 0


# -------------------------------------------------------------------- linear
def _activate(y, act: str):
    if act == "relu":
        return torch.relu(y)
    if act == "gelu":  # exact erf GELU (torch nn.GELU)
        return 0.5 * y * (1.0 + torch.erf(y * (2.0**-0.5)))
    if act != "none":
        raise ValueError(f"unknown activation {act!r}")
    return y


def linear_plain(a, w, bias, act: str = "none", residual=None,
                 round_a: bool = False):
    if round_a:
        a = round_bf16(a)
    y = _activate(a @ w.float() + bias, act)
    return y if residual is None else y + residual


def linear(a, w, bias, act: str = "none", residual=None, round_a: bool = False):
    """``act(a @ w + bias) [+ residual]``; a (M, K) float32, w (K, N) float32
    or bfloat16, bias (N,), residual (M, N)."""
    if not _on_card(a, w, bias, residual):
        return linear_plain(a, w, bias, act, residual, round_a)
    M, K = a.shape
    N = w.shape[1]
    _check(a, "a", (M, K))
    _check(w, "w", (K, N), (torch.float32, torch.bfloat16))
    _check(bias, "bias", (N,))
    _check(residual, "residual", (M, N))
    y = torch.empty((M, N), device=a.device, dtype=torch.float32)
    _launch(load_library().pd_linear, _ptr(a), _ptr(w),
            int(w.dtype == torch.bfloat16), _ptr(bias), _ptr(residual),
            _ptr(y), M, N, K, int(round_a), _ACT[act], _stream(a))
    linear.launches += 1
    return y


linear.launches = 0


# ----------------------------------------------------------------- attention
def attention_plain(qkv, nhead: int, attn_bias=None, key_bias=None,
                    round_in: bool = False):
    B, N, D3 = qkv.shape
    D = D3 // 3
    Dh = D // nhead
    q, k, v = qkv.view(B, N, 3, nhead, Dh).permute(2, 0, 3, 1, 4)
    if round_in:
        q, k, v = round_bf16(q), round_bf16(k), round_bf16(v)
    s = (q @ k.transpose(-1, -2)) * (1.0 / Dh**0.5)
    if attn_bias is not None:
        s = s + attn_bias
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    if round_in:
        p = round_bf16(p)
    return (p @ v).transpose(1, 2).reshape(B, N, D)


def attention_smem_bytes(N: int, Dh: int) -> int:
    """Dynamic shared memory of one attention block of 8 warps
    (csrc/attention.cu, attention_smem_bytes)."""
    return 4 * (2 * N * (Dh + 1) + 8 * (Dh + N))


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def attention(qkv, nhead: int, attn_bias=None, key_bias=None,
              round_in: bool = False):
    """Softmax attention of a packed (B, N, 3D) QKV buffer -> (B, N, D).

    ``attn_bias`` (N, N) is shared by every sequence (the ViT's
    block-diagonal scale packing); ``key_bias`` (B, N) masks keys (the
    denoiser's frame mask). Use NEG, not -inf, for a masked entry."""
    if attn_bias is not None and key_bias is not None:
        raise ValueError("pass attn_bias or key_bias, not both")
    if not _on_card(qkv, attn_bias, key_bias):
        return attention_plain(qkv, nhead, attn_bias, key_bias, round_in)
    B, N, D3 = qkv.shape
    D = D3 // 3
    Dh = D // nhead
    if D3 != 3 * D or D != nhead * Dh:
        raise ValueError(f"qkv width {D3} does not split into 3 x {nhead} heads")
    if attention_smem_bytes(N, Dh) > _MAX_SMEM:
        raise ValueError(f"N={N}, Dh={Dh}: one head's K and V exceed shared memory")
    _check(qkv, "qkv", (B, N, D3))
    _check(attn_bias, "attn_bias", (N, N))
    _check(key_bias, "key_bias", (B, N))
    bias, kind = (attn_bias, 1) if attn_bias is not None else (
        (key_bias, 2) if key_bias is not None else (None, 0)
    )
    out = torch.empty((B, N, D), device=qkv.device, dtype=torch.float32)
    _launch(load_library().pd_attention, _ptr(qkv), _ptr(bias), kind,
            _ptr(out), B, N, nhead, Dh, 1.0 / Dh**0.5, int(round_in),
            _stream(qkv))
    attention.launches += 1
    return out


attention.launches = 0


# ---------------------------------------------------------- sampler fold-ins
def _harmonic_args(x, n_harmonics: int):
    """(rows, T) -> (rows, T * F) with column d*F + f = x[d] * 2^f."""
    freqs = 2.0 ** torch.arange(n_harmonics, dtype=x.dtype, device=x.device)
    return (x[:, :, None] * freqs).reshape(x.shape[0], -1)


def sampler_prologue_plain(x, wsin, wcos, wx, zf, tc, step: int):
    S = _harmonic_args(x, wsin.shape[0] // x.shape[1])
    return torch.sin(S) @ wsin + torch.cos(S) @ wcos + x @ wx + zf + tc[step]


def sampler_prologue(x, wsin, wcos, wx, zf, tc, step: int):
    """Layer-0 input of reverse step ``step``: (rows, T) state -> (rows, D)."""
    if not _on_card(x, wsin, wcos, wx, zf, tc):
        return sampler_prologue_plain(x, wsin, wcos, wx, zf, tc, step)
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
    h = torch.empty((rows, D), device=x.device, dtype=torch.float32)
    _launch(load_library().pd_sampler_prologue, _ptr(x), _ptr(wsin),
            _ptr(wcos), _ptr(wx), _ptr(zf), _ptr(tc), _ptr(h), rows, D, TD,
            HH // TD, step, _stream(x))
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
    if not _on_card(h, w0, b0, gh, bh, w1, b1, coef, noise, x):
        return sampler_epilogue_plain(h, w0, b0, gh, bh, w1, b1, coef, noise,
                                      x, step, eps)
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
    _launch(load_library().pd_sampler_epilogue, _ptr(h), _ptr(w0), _ptr(b0),
            _ptr(gh), _ptr(bh), _ptr(w1), _ptr(b1), _ptr(coef), _ptr(noise),
            _ptr(x), rows, D, HID, TD, step, eps, _stream(h))
    sampler_epilogue.launches += 1
    return x


sampler_epilogue.launches = 0


# ------------------------------------------------------------------- tables
KERNELS = SimpleNamespace(
    layernorm=layernorm, linear=linear, attention=attention,
    sampler_prologue=sampler_prologue, sampler_epilogue=sampler_epilogue,
)
PLAIN = SimpleNamespace(
    layernorm=layernorm_plain, linear=linear_plain, attention=attention_plain,
    sampler_prologue=sampler_prologue_plain,
    sampler_epilogue=sampler_epilogue_plain,
)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in vars(KERNELS).items()}


def reset_launch_counts() -> None:
    for fn in vars(KERNELS).values():
        fn.launches = 0
