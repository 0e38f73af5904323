"""The least time of a piece of work on one H100, from its shapes.

The arithmetic of ``chip_smoke.py`` (``bound``, ``attention_bound``,
``attention_bwd_bound``, ``linear_bound``, ``wgrad_bound``, ``block_flops``),
frozen here as the benchmark's yardstick and taken from shapes instead of
tensors. One change: every product is counted once, at the peak of its
stated precision (``peaks.PEAK_BY_PRECISION``), whatever route a kernel takes
(``chip_smoke.py`` counts a 3xTF32 product three times). So a bound is the
least time any implementation of the work could take, and a share of it
cannot pass 100% unless the work was counted too high or its time too low.

Bytes: each input read once and each output written once, float32 (4 bytes)
unless stated; a masked attention cell is no work (the block-diagonal
packing of the ViT's scales, a padded frame's key).
"""

from __future__ import annotations

from perfbench.roofline.peaks import HBM_BYTES_PER_S

F32 = 4


def bound(nbytes: float, flops: float, peak: float):
    """(least ms, what bounds it) for work that moves ``nbytes`` through HBM
    and does ``flops`` operations at ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def linear(M: int, K: int, N: int, peak: float, bias: bool = True,
           residual: bool = False):
    """(flops, least ms) of y = a W [+ b] [+ residual]: a (M, K), W (K, N)."""
    flops = 2 * M * K * N
    nbytes = F32 * (M * K + K * N + (N if bias else 0) + (M * N if residual else 0) + M * N)
    return flops, bound(nbytes, flops, peak)[0]


def dgrad(M: int, K: int, N: int, peak: float):
    """(flops, least ms) of da = dY W^T: dY (M, N), W (K, N), da (M, K)."""
    flops = 2 * M * K * N
    return flops, bound(F32 * (M * N + K * N + M * K), flops, peak)[0]


def wgrad(M: int, K: int, N: int, peak: float, bias: bool = True):
    """(flops, least ms) of dW = X^T dY and db = colsum(dY): X (M, K), dY
    (M, N)."""
    flops = 2 * M * K * N
    return flops, bound(F32 * (M * K + M * N + K * N + (N if bias else 0)), flops, peak)[0]


def attention(cells: int, rows: int, D: int, peak: float):
    """(flops, least ms) of softmax attention's forward over ``cells`` live
    (query, key) pairs: q k^T and p v, 4 D operations a cell; the packed
    qkv (rows, 3D) read once, the output (rows, D) written once."""
    flops = 4 * cells * D
    return flops, bound(F32 * (rows * 3 * D + rows * D), flops, peak)[0]


def attention_bwd(cells: int, rows: int, D: int, peak: float):
    """(flops, least ms) of attention's backward without recomputation:
    dV = p^T dO, dp = dO V^T, dQ = ds K and dK = ds^T Q, 8 D operations a
    cell; qkv and dO read once, dqkv written once."""
    flops = 8 * cells * D
    return flops, bound(F32 * (rows * 3 * D + rows * D + rows * 3 * D), flops, peak)[0]


def elementwise(n: int, reads: int, writes: int):
    """(0, least ms) of an elementwise pass over ``n`` elements reading
    ``reads`` and writing ``writes`` float32 arrays of that size."""
    return 0, bound(F32 * n * (reads + writes), 0, 1.0)[0]


def layernorm(rows: int, D: int):
    """(0, least ms) of a LayerNorm forward: x read, y written, g and b."""
    return 0, bound(F32 * (2 * rows * D + 2 * D), 0, 1.0)[0]


def layernorm_bwd(rows: int, D: int, residual: bool = True):
    """(0, least ms) of a LayerNorm backward: x and dy read (and the
    residual's cotangent), dx written, dg and db written."""
    return 0, bound(F32 * ((3 + int(residual)) * rows * D + 2 * D), 0, 1.0)[0]
