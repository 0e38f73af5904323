"""Why the tensor-core kernels take three TF32 products, and the launch
arithmetic they share with their Python wrappers, on the CPU.

``linear`` (csrc/linear.cu, linear_tf32_kernel: the forward and dgrad
products of float32 a), ``linear_wgrad`` (wgrad_tf32_kernel) and
``attention_bwd`` (csrc/attention_bwd.cu) run their float32 products as
3xTF32 MMAs: each operand x splits into hi = tf32(x) (round to nearest at 10
mantissa bits, cvt.rna) and lo = x - hi, which the tensor core truncates to
TF32, and a product is hi.hi + hi.lo + lo.hi. The emulation here (products
of the TF32 values exact in float64) shows that this lands within 1e-5 of
float64 on the path's products, the card tests' float32 tolerance, and that
one TF32 product (hi.hi alone) does not; that a bf16 W or a bf16-rounded a
has lo = 0, so the kernel's two products equal three bitwise; and, with the
tensor core's truncating accumulation emulated, that a fresh accumulator per
slice of K (64 wide in ``linear``, 32 rows in ``linear_wgrad``) is what
keeps K 1,536 within 1e-5. SuperGlue's scores (csrc/superglue.cu) take the
same three products; the scores' scratch size mirrors the kernel's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from posediffusion_tpu_torch.ops import kernels as K

TOL = 1e-5  # tests/test_torch_cuda.py TOL_F32: kernel against plain, float32


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the low 13 mantissa bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32_round(x)
    return hi, _tf32_trunc(x - hi)


def _product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b (float32 operands) as the tensor cores take it: 3 (hi.hi + hi.lo +
    lo.hi) or 1 (hi.hi) TF32 products, each exact, summed in float64."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    out = ah.double() @ bh.double()
    if terms == 3:
        out = out + ah.double() @ bl.double() + al.double() @ bh.double()
    return out


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return ((out - ref).abs().max() / ref.abs().max()).item()


def test_split_is_exact_and_rounds_to_nearest():
    x = torch.tensor(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi, lo = _split(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((x - hi).abs() <= x.abs() * 2.0**-11)  # round to nearest: half a TF32 ulp
    assert torch.all((x.double() - hi.double() - lo.double()).abs() <= x.abs().double() * 2.0**-21)
    # a tie rounds away from zero (cvt.rna)
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)], dtype=torch.float32)
    assert torch.equal(_tf32_round(tie), torch.tensor([1.0 + 2.0**-10, -(1.0 + 2.0**-10)]))


def test_fc1_weight_gradient_needs_three_products():
    """dW = X^T dY at fc1's widths (K 384, N 1,536) over a few thousand rows."""
    r = np.random.default_rng(1)
    x = torch.tensor(r.normal(size=(2048, 384)).astype(np.float32))
    dy = torch.tensor(r.normal(size=(2048, 1536)).astype(np.float32))
    ref = x.double().t() @ dy.double()
    three = _rel(_product(x.t(), dy, 3), ref)
    one = _rel(_product(x.t(), dy, 1), ref)
    assert three <= TOL, three
    assert one > TOL, one


def _attention_case(N=264, Dh=64, seed=2):
    """One head of the ViT at 264 packed tokens (the 197 / 50 / 17 scale
    packing bias): q, k, v, do and, from float64, p and ds as the kernels
    form them before their products."""
    r = np.random.default_rng(seed)
    q, k, v, do = (torch.tensor(r.normal(size=(N, Dh)).astype(np.float32)) for _ in range(4))
    seg = torch.tensor([0] * 197 + [1] * 50 + [2] * 17)
    bias = torch.where(seg[:, None] == seg[None], 0.0, K.NEG).double()
    scale = Dh**-0.5
    p = torch.softmax((q.double() @ k.double().t()) * scale + bias, -1)
    dp = do.double() @ v.double().t()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return q, k, v, do, p.float(), ds.float()


@pytest.mark.parametrize("product", ["q k^T", "do v^T", "p^T do", "ds k", "ds^T q"])
def test_attention_products_need_three_products(product):
    q, k, v, do, p, ds = _attention_case()
    a, b = {"q k^T": (q, k.t()), "do v^T": (do, v.t()), "p^T do": (p.t(), do),
            "ds k": (ds, k), "ds^T q": (ds.t(), q)}[product]
    ref = a.double() @ b.double()
    three = _rel(_product(a, b, 3), ref)
    one = _rel(_product(a, b, 1), ref)
    assert three <= TOL, three
    assert one > TOL, one


# ---- linear's forward and dgrad products (csrc/linear.cu, linear_tf32_kernel)
# (K, N) of the path's products: SuperGlue's qkv, the ViT's qkv, SuperGlue's
# w1 (and the encoder's widths), fc2; with trans_w the same W read as (N, K),
# the dgrad product dY W^T of a forward weight
LINEAR_SHAPES = [(256, 768), (384, 1152), (512, 512), (1536, 384)]


def _operands(K_, N, trans, seed):
    r = np.random.default_rng(seed)
    a = torch.tensor(r.normal(size=(512, K_)).astype(np.float32))
    w = torch.tensor((r.normal(size=(N, K_) if trans else (K_, N)) / np.sqrt(K_))
                     .astype(np.float32))
    return a, (w.t() if trans else w)


@pytest.mark.parametrize("K_,N", LINEAR_SHAPES)
@pytest.mark.parametrize("trans", [False, True])
def test_linear_products_need_three_products(K_, N, trans):
    a, w = _operands(K_, N, trans, K_ + N + trans)
    ref = a.double() @ w.double()
    three = _rel(_product(a, w, 3), ref)
    one = _rel(_product(a, w, 1), ref)
    assert three <= TOL, three
    assert one > TOL, one


@pytest.mark.parametrize("exact", ["bf16 W", "rounded a"])
@pytest.mark.parametrize("K_,N", [(384, 1152), (1536, 384)])
def test_two_products_equal_three_for_a_bf16_operand(exact, K_, N):
    """A bf16 value has 8 mantissa bits, so tf32 keeps it whole and its lo
    is exactly 0: the product the kernel skips (lo.hi for a rounded a, hi.lo
    for a bf16 W) adds exactly 0, in the kernel's order lo.hi, hi.lo, hi.hi."""
    a, w = _operands(K_, N, False, 7)
    if exact == "bf16 W":
        w = K.round_bf16(w)
    else:
        a = K.round_bf16(a)
    (ah, al), (bh, bl) = _split(a), _split(w)
    assert torch.count_nonzero(bl if exact == "bf16 W" else al) == 0
    three = (al.double() @ bh.double() + ah.double() @ bl.double()) + ah.double() @ bh.double()
    two = (ah.double() @ bl.double() if exact == "rounded a" else al.double() @ bh.double()) \
        + ah.double() @ bh.double()
    assert torch.equal(three, two)
    assert _rel(two, a.double() @ w.double()) <= TOL


def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero (the tensor core's accumulator)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _mma_chain(a: torch.Tensor, b: torch.Tensor, slice_k: int) -> torch.Tensor:
    """a @ b as a chain of m16n8k8 3xTF32 MMAs: each MMA adds its eight exact
    products to the accumulator and truncates the sum to float32. With
    ``slice_k`` each slice of K goes into a fresh accumulator that is added
    into the running sum rounded to nearest (the kernels' design); with 0
    one accumulator runs over the whole of K."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    tmp = torch.zeros_like(acc)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            tmp = _rz(tmp.double() + x[:, ks].double() @ y[ks].double())
        if slice_k and (k0 + 8) % slice_k == 0:
            acc, tmp = acc + tmp, torch.zeros_like(tmp)
    return acc + tmp


def test_a_fresh_accumulator_per_slice_holds_k_1536():
    """fc2's product (K 1,536, N 384): 576 truncating MMAs into one
    accumulator drift past 1e-5; a fresh accumulator per 64-wide slice
    (linear_tf32_kernel's LT_BK) stays near float32's own rounding."""
    r = np.random.default_rng(0)
    a = torch.tensor(r.normal(size=(256, 1536)).astype(np.float32))
    w = torch.tensor((r.normal(size=(1536, 384)) / np.sqrt(1536)).astype(np.float32))
    ref = a.double() @ w.double()
    sliced = _rel(_mma_chain(a, w, 64).double(), ref)
    running = _rel(_mma_chain(a, w, 0).double(), ref)
    assert sliced <= TOL / 10, sliced
    assert running > TOL, running


# ---- the weight gradient's row split (csrc/linear.cu, pd_linear_wgrad)
ROWS = {"vit": 512 * 264, "dinov2": 512 * 348, "encoder": 2880 * 16}
# (rows, K, N) of every weight gradient on the train path: the ViTs' qkv,
# proj, fc1 and fc2 (ViT-S 384 wide, ViT-B 768), the encoder's in_proj,
# out_proj, linear1 and linear2
PATH_SHAPES = [
    (ROWS[m], k, n) for m in ("vit", "dinov2")
    for k, n in ((384, 1152), (384, 384), (384, 1536), (1536, 384))
] + [
    (ROWS["vit"], k, n) for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768))
] + [
    (ROWS["encoder"], k, n) for k, n in ((512, 1536), (512, 512), (512, 1024), (1024, 512))
]


@pytest.mark.parametrize("M,K_,N", PATH_SHAPES)
def test_wgrad_split_fills_the_card(M, K_, N):
    """float32 mode: one block an SM, so at least 132 blocks and their last
    wave 90% full; every row in exactly one split of at least 1,024 rows."""
    tile = K.WGRAD_TILE[False]
    assert tile == 128
    rows = K.wgrad_rows(M, K_, N)
    splits = -(-M // rows)
    assert splits * rows >= M and (splits - 1) * rows < M
    assert rows >= 1024
    blocks = -(-K_ // tile) * -(-N // tile) * splits
    assert blocks >= 132
    assert blocks / (132 * -(-blocks // 132)) >= 0.9


@pytest.mark.parametrize("M,K_,N", [(77, 130, 70), (1000, 384, 1536), (5000, 64, 64),
                                    (3001, 384, 256)])
@pytest.mark.parametrize("round_in", [False, True])
def test_wgrad_split_small_and_bf16(M, K_, N, round_in):
    """Few rows: as many splits as 1,024-row ranges allow; bf16 mode's wgmma
    tile is float32 mode's 128 x 128, one block an SM, so both modes split
    alike. Every row in exactly one split."""
    rows = K.wgrad_rows(M, K_, N, round_in)
    splits = -(-M // rows)
    assert splits * rows >= M and (splits - 1) * rows < M
    assert splits <= max(1, -(-M // 1024))
    assert K.WGRAD_TILE[round_in] == 128
    assert rows == K.wgrad_rows(M, K_, N, not round_in)


# ---- attention_bwd's shared memory (csrc/attention_bwd.cu, smem_bytes)
@pytest.mark.parametrize("N", [1, 16, 264, 348, 593, 4096])
@pytest.mark.parametrize("Dh", [64, 128])
def test_attention_bwd_shared_memory_fits(N, Dh):
    """Under the 232,448 B a Hopper block may use, in both modes (one layout)
    and at any N: the tiles do not grow with N."""
    smem = K.attention_bwd_smem_bytes(N, Dh)
    assert smem <= 232448
    assert smem <= K.attention_bwd_smem_bytes(4096, Dh)


def test_attention_bwd_shared_memory_at_the_path_shapes():
    """Worked by hand: ViT (Dh 64, 264 tokens): 4 warps of 16 k and v rows
    and 2 stages of 32 queries with their dout rows, 72 floats a row, and 3
    statistics a query; the denoiser (Dh 128, 16 frames): 1 warp, one
    16-query tile, 136 floats a row."""
    assert K.attention_bwd_smem_bytes(264, 64) == 4 * (2 * 64 * 72 + 2 * 2 * 32 * 72 + 3 * 2 * 32)
    assert K.attention_bwd_smem_bytes(16, 128) == 4 * (2 * 16 * 136 + 2 * 16 * 136 + 3 * 16)
    assert K.attention_bwd_smem_bytes(593, 128) == 104832


# ---- SuperGlue's scores (csrc/superglue.cu, sg_scores_kernel): m0 m1^T / 16
# for one pair of 1,024 keypoints at D 256, both operands K-major
@pytest.mark.parametrize("D", [64, 256])
def test_superglue_scores_need_three_products(D):
    r = np.random.default_rng(D)
    m = torch.tensor((r.normal(size=(2, 1024, D)) / np.sqrt(D) * 4).astype(np.float32))
    ref = m[0].double() @ m[1].double().t()
    three = _rel(_product(m[0], m[1].t(), 3), ref)
    one = _rel(_product(m[0], m[1].t(), 1), ref)
    assert three <= TOL, three
    assert one > TOL, one


SUPERGLUE_CU = Path(K.__file__).resolve().parents[1] / "csrc" / "superglue.cu"


def test_sg_scores_scratch_mirrors_the_kernel():
    """kernels.sg_scores_scratch counts what csrc/superglue.cu's
    pd_sg_scores_scratch does: the tile side is the kernel's SC_BM and SC_BN,
    the scratch its tile flags (C, 2, n), tile list (C n^2) and live count;
    at the match path's chunk (32 pairs of 1,024 keypoints) 2,048 tiles."""
    src = SUPERGLUE_CU.read_text()
    tile = re.search(r"constexpr int SC_BM = (\d+), SC_BN = (\d+)", src)
    assert tile and int(tile.group(1)) == int(tile.group(2)) == K.SG_TILE
    assert "return (int)(2LL * C * sc_tiles_1d(K) + sc_tiles(C, K) + 1);" in src
    assert K.sg_scores_scratch(32, 1024) == 2 * 32 * 8 + 32 * 64 + 1
    assert K.sg_scores_scratch(3, 37) == 3 * 2 + 3 + 1
    assert K.sg_scores_scratch(2, 129) == 2 * 2 * 2 + 2 * 4 + 1
    assert K.sg_scores_scratch(32, 4096) == 2 * 32 * 32 + 32 * 32 * 32 + 1
