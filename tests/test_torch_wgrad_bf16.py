"""The bf16 mode's weight gradient, on the CPU.

``linear_wgrad(x, dy, round_in=True)`` runs on bf16 ``wgmma`` on the card
(csrc/wgrad.cu, wgrad_bf16_wgmma_kernel): one block per (row split, 128 x
128 tile of dW), the split's rows 32 at a time, both operands rounded to
bf16, every product exact and summed by the tensor core, which truncates
its sums. So each 64 rows go into a fresh accumulator that is added,
rounded to nearest, into the running one; the splits' partials are summed
in order. db sums the unrounded dy: warp w of a block adds rows w, w + 8,
w + 16, w + 24 of each 32-row slice, the 8 warps' sums are added in order.

Here that order is emulated (float64 sums truncated to float32 per k16
step) and held against the plain version and against the JAX package's
lines (posediffusion_tpu/ops/vit_train_kernel.py _mlp_residual_bwd,
``dot_general(cast(hf), cast(da1), (((0,), (0,)), ...))`` and
``jnp.sum(da1, axis=0)``), at ragged M, K and N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posediffusion_tpu.ops.vit_train_kernel import _cast_fn
from posediffusion_tpu_torch.ops import kernels as K

TOL = 1e-5  # float32 sums in another order, relative to max |reference|
GROUP = 64  # rows a fresh accumulator sums
SLICE = 32  # rows a ring slot holds (db's warp order)


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero (the tensor core's accumulator)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _group_sum(xr: torch.Tensor, dyr: torch.Tensor) -> torch.Tensor:
    """xr^T dyr over at most 64 rows as the tensor core runs it: k16 steps,
    each adding its sixteen exact products and truncating to float32."""
    tmp = torch.zeros(xr.shape[1], dyr.shape[1])
    xd, dd = xr.double(), dyr.double()
    for m0 in range(0, xr.shape[0], 16):
        tmp = _rz(tmp.double() + xd[m0:m0 + 16].t() @ dd[m0:m0 + 16])
    return tmp


def wgrad_emulated(x: torch.Tensor, dy: torch.Tensor, group: int = GROUP):
    """(dW, db) in the kernel's order; ``group`` rows a fresh accumulator
    (0: one accumulator over the whole split)."""
    M, Kx = x.shape
    N = dy.shape[1]
    rows = K.wgrad_rows(M, Kx, N, round_in=True)
    xr, dyr = K.round_bf16(x), K.round_bf16(dy)
    dw, db = torch.zeros(Kx, N), torch.zeros(N)
    for r0 in range(0, M, rows):
        r1 = min(M, r0 + rows)
        acc = torch.zeros(Kx, N)
        if group:
            for g0 in range(r0, r1, group):
                acc = acc + _group_sum(xr[g0:min(r1, g0 + group)], dyr[g0:min(r1, g0 + group)])
        else:
            acc = _group_sum(xr[r0:r1], dyr[r0:r1])
        bs = torch.zeros(8, N)  # warp w's column sums
        for s0 in range(r0, r1, SLICE):
            d = torch.zeros(SLICE, N)
            d[:min(SLICE, r1 - s0)] = dy[s0:min(r1, s0 + SLICE)]
            for i in range(SLICE // 8):
                bs = bs + d[8 * i:8 * i + 8]
        red = torch.zeros(N)
        for w in range(8):
            red = red + bs[w]
        dw, db = dw + acc, db + red
    return dw, db


def _jax_lines(x: np.ndarray, dy: np.ndarray):
    """_mlp_residual_bwd's weight and bias gradient lines (act_bf16)."""
    cast = _cast_fn(True)
    hf, da1 = jnp.asarray(x), jnp.asarray(dy)
    w = jax.lax.dot_general(cast(hf), cast(da1), (((0,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
    return np.array(w), np.array(jnp.sum(da1, axis=0))


def _rel(out, ref):
    ref = torch.as_tensor(np.asarray(ref)).double()
    return ((torch.as_tensor(np.asarray(out)).double() - ref).abs().max()
            / max(1.0, ref.abs().max().item())).item()


# ragged M (one row, under and over a slice, a split's tail), K and N off
# the 128-wide tile and off 16
@pytest.mark.parametrize("M,K_,N", [(1, 16, 8), (63, 130, 70), (65, 64, 24), (1000, 130, 70),
                                    (2085, 200, 136), (4133, 24, 40)])
def test_kernel_order_matches_plain_and_jax(M, K_, N):
    r = np.random.default_rng(M)
    x = r.normal(size=(M, K_)).astype(np.float32)
    dy = r.normal(size=(M, N)).astype(np.float32)
    dw, db = wgrad_emulated(torch.tensor(x), torch.tensor(dy))
    pw, pb = K.linear_wgrad_plain(torch.tensor(x), torch.tensor(dy), True)
    jw, jb = _jax_lines(x, dy)
    assert _rel(dw, pw) <= TOL and _rel(dw, jw) <= TOL
    assert _rel(db, pb) <= TOL and _rel(db, jb) <= TOL
    # the CPU route of the wrapper is the plain version
    kw, kb = K.linear_wgrad(torch.tensor(x), torch.tensor(dy), True)
    assert torch.equal(kw, pw) and torch.equal(kb, pb)


def test_all_zero_dy_gives_zero_gradients():
    x = torch.tensor(np.random.default_rng(1).normal(size=(300, 130)).astype(np.float32))
    dw, db = wgrad_emulated(x, torch.zeros(300, 70))
    assert not dw.any() and not db.any()


def test_a_fresh_accumulator_per_64_rows_keeps_float32_accuracy():
    """Over fc1's split of 12,288 rows (positive operands, the worst case for
    a truncating sum) one accumulator drifts by a bias that grows with the
    rows; a fresh one per 64 rows stays near float32's own rounding."""
    r = np.random.default_rng(7)
    M = 12288
    assert K.wgrad_rows(135_168, 384, 1536, True) == M
    xr = K.round_bf16(torch.tensor(np.abs(r.normal(size=(M, 8))).astype(np.float32)))
    dyr = K.round_bf16(torch.tensor(np.abs(r.normal(size=(M, 8))).astype(np.float32)))
    ref = xr.double().t() @ dyr.double()
    acc = torch.zeros(8, 8)
    for g0 in range(0, M, GROUP):
        acc = acc + _group_sum(xr[g0:g0 + GROUP], dyr[g0:g0 + GROUP])
    grouped = _rel(acc, ref)
    running = _rel(_group_sum(xr, dyr), ref)
    assert grouped <= TOL / 10, grouped
    assert running > 10 * grouped, (running, grouped)
