"""``layernorm_bwd``'s plain version against the JAX package's ``_ln_bwd``,
and the launch arithmetic its wrapper mirrors, on the CPU.

The port's kernel (csrc/layernorm.cu) computes ``_ln_bwd``
(posediffusion_tpu/ops/vit_train_kernel.py:265-275) from the saved input x,
recomputing x-hat and rstd as ``_ln_fwd`` forms them, with the residual
cotangent added (:353, :488). On the CPU the wrapper takes its plain
version, which the card tests and chip_smoke.py hold the kernel to.
Inputs are seeded numpy at the ViT-S and ViT-B widths (D 384 and 768).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.ops import vit_train_kernel as JV
from posediffusion_tpu_torch.ops import kernels as K

EPS = 1e-6  # the ViT's LayerNorm
TOL = 2e-5  # float32 sums in another order (tests/test_torch_train_kernel.py)


def _inputs(rows, D, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(rows, D)) * 2 + 1).astype(np.float32)
    g = (1 + 0.1 * r.normal(size=D)).astype(np.float32)
    dh = r.normal(size=(rows, D)).astype(np.float32)
    res = r.normal(size=(rows, D)).astype(np.float32)
    return x, g, dh, res


def _jax_ln_bwd(x, g, dh, res):
    """``_ln_bwd`` from ``_ln_fwd``'s x-hat and rstd, plus the residual
    cotangent as ``_mlp_residual_bwd`` adds it (dyf + dxf)."""
    _, xhat, rstd = JV._ln_fwd(jnp.asarray(x), jnp.asarray(g), jnp.zeros_like(g), EPS)
    dx, dg, db = JV._ln_bwd(jnp.asarray(dh), xhat, rstd, jnp.asarray(g))
    if res is not None:
        dx = jnp.asarray(res) + dx
    return [np.asarray(v) for v in (dx, dg, db)]


@pytest.mark.parametrize("D", [384, 768])
@pytest.mark.parametrize("with_res", [False, True])
def test_plain_matches_jax_ln_bwd(D, with_res):
    x, g, dh, res = _inputs(97, D, D + with_res)
    res = res if with_res else None
    ours = K.layernorm_bwd(torch.tensor(x), torch.tensor(g), torch.tensor(dh), EPS,
                           residual=None if res is None else torch.tensor(res))
    for name, a, b in zip(("dx", "dg", "db"), ours, _jax_ln_bwd(x, g, dh, res)):
        scale = max(1.0, np.abs(b).max())
        err = np.abs(a.numpy() - b).max()
        assert err <= TOL * scale, f"{name}: {err:.3e} > {TOL:.0e} x {scale:.3g}"


def test_plain_rounds_the_sum_with_round_out():
    """``round_out`` rounds dx + residual to bf16 (a bf16 residual stream)."""
    x, g, dh, res = (torch.tensor(v) for v in _inputs(33, 384, 5))
    dx, dg, db = K.layernorm_bwd(x, g, dh, EPS, residual=res, round_out=True)
    ref, rg, rb = K.layernorm_bwd(x, g, dh, EPS, residual=res)
    assert torch.equal(dx, K.round_bf16(ref))
    assert torch.equal(dg, rg) and torch.equal(db, rb)


# ---- the grid (csrc/layernorm.cu lnb_blocks): at most two blocks of 8
# warps on each of the H100's 132 SMs, one row a warp below that
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 1000, 2111, 2112, 2113, 46080, 135168, 178176])
def test_grid_covers_every_row_once(rows):
    blocks = K.layernorm_bwd_blocks(rows)
    assert 1 <= blocks <= K.LAYERNORM_BWD_MAX_BLOCKS == 264
    warps = blocks * K.LAYERNORM_BWD_WARPS
    # warp w walks rows w, w + warps, ...: every row once, no warp idle
    # while another has two rows more than it
    walked = sorted(r for w in range(warps) for r in range(w, rows, warps))
    assert walked == list(range(rows))
    per_warp = [len(range(w, rows, warps)) for w in range(warps)]
    assert max(per_warp) - min(per_warp) <= 1
    if rows <= K.LAYERNORM_BWD_MAX_BLOCKS * K.LAYERNORM_BWD_WARPS:
        assert blocks == -(-rows // K.LAYERNORM_BWD_WARPS)


@pytest.mark.parametrize("rows,blocks", [(135168, 264), (46080, 264), (178176, 264), (40, 5)])
def test_partials_at_the_path_shapes(rows, blocks):
    """264 dg / db partials at the train path's row counts (the ViT's 512 x
    264, the encoder's 2,880 x 16, DINOv2's 512 x 348), not one per 128 rows
    (1,056, 360 and 1,392 before)."""
    assert K.layernorm_bwd_blocks(rows) == blocks
