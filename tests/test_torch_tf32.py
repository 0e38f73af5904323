"""Why the tensor-core kernels take three TF32 products, and the launch
arithmetic they share with their Python wrappers, on the CPU.

``linear`` (csrc/linear.cu, linear_tf32_kernel: the forward and dgrad
products of float32 a), ``linear_wgrad`` (wgrad_tf32_wgmma_kernel and
its fallback wgrad_tf32_kernel) and
``attention_bwd`` (csrc/attention_bwd.cu) run their float32 products as
3xTF32 MMAs: each operand x splits into hi = tf32(x) (round to nearest at 10
mantissa bits, cvt.rna) and lo = x - hi, which the tensor core truncates to
TF32, and a product is hi.hi + hi.lo + lo.hi. The emulation here (products
of the TF32 values exact in float64) shows that this lands within 1e-5 of
float64 on the path's products, the card tests' float32 tolerance, and that
one TF32 product (hi.hi alone) does not; that a bf16 W or a bf16-rounded a
has lo = 0, so the kernel's two products equal three bitwise; and, with the
tensor core's truncating accumulation emulated, that a fresh accumulator per
slice of K (64 wide in ``linear``, 32 rows in wgrad_tf32_kernel) is what
keeps K 1,536 within 1e-5. SuperGlue's scores (csrc/superglue.cu) take the
same three products; the scores' scratch size mirrors the kernel's. The
weight gradient's TF32 wgmma tile (wgrad_tf32_wgmma_kernel) sums each 64
rows apart: its order, emulated over whole row splits and their partials,
holds float64 as closely.
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


# ---- the TF32 wgmma route (csrc/linear.cu, linear_tf32_wgmma_kernel)
def _wgmma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as linear_tf32_wgmma_kernel sums it: 32-wide ring slots of four
    k8 wgmma steps (zeros past K, as TMA fills them), each running lo.hi,
    hi.lo and hi.hi into one accumulator that truncates its sums; the
    accumulator is zeroed (scale-d 0) at the first step of every other slot
    and added, rounded to nearest, into the running sum after every second
    slot and after the last."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    Kd = a.shape[1]
    slots = -(-Kd // 32)
    acc, part = None, None
    for sl in range(slots):
        for kk in range(4):
            ks = slice(min(Kd, 32 * sl + 8 * kk), min(Kd, 32 * sl + 8 * kk + 8))
            for i, (x, y) in enumerate(((al, bh), (ah, bl), (ah, bh))):
                prod = x[:, ks].double() @ y[ks].double()
                zero = i == 0 and kk == 0 and sl % 2 == 0
                part = _rz(prod if zero else part.double() + prod)
        if sl % 2 == 1 or sl == slots - 1:
            acc = part if sl < 2 else acc + part
    return acc


@pytest.mark.parametrize("K_,N,trans", [(1536, 384, False), (1536, 384, True),
                                        (1544, 200, False), (392, 1152, True)])
def test_wgmma_route_accumulation_holds_k_1536(K_, N, trans):
    """fc2's product and the dgrad of fc1 (K 1,536, N 384; with trans_w the
    same sums over W read as (N, K)), a K off 64 (1,544: the last 64-wide
    slice one slot) and qkv's dgrad: the new kernel's order stays near
    float32's own rounding, and it is linear_tf32_kernel's order (a fresh
    accumulator per 64 of K, three products a k8 step), bitwise."""
    a, w = _operands(K_, N, trans, K_ + N)
    ref = a.double() @ w.double()
    out = _wgmma_chain(a, w)
    assert _rel(out.double(), ref) <= TOL / 10, _rel(out.double(), ref)
    assert torch.equal(out, _mma_chain(a, w, 64))


# (M, K, N) of the cells' train-trunk products: DINO's and DINOv2's ViT
# (512 x 264 and 512 x 348 rows) and the encoder (2,880 x 16 rows), each
# forward (K, N) and its dgrad (W (K, N) read transposed: K <-> N)
CELL_PRODUCTS = [
    (m, k, n) for m in (512 * 264, 512 * 348)
    for k, n in ((384, 1152), (384, 384), (384, 1536), (1536, 384), (1152, 384))
] + [(2880 * 16, k, n) for k, n in ((512, 1536), (512, 512), (512, 1024), (1024, 512),
                                    (1536, 512))]


@pytest.mark.parametrize("M,K_,N", CELL_PRODUCTS)
def test_cell_products_take_the_wgmma_route_and_tile_exactly(M, K_, N):
    """Every train-trunk product of both cells goes to TF32 wgmma and
    tiles exactly: 128 x 128 tiles, whole 32-wide K slots, whole 64-wide
    accumulator slices."""
    assert K.linear_route(K_, N, False, False) == "tf32_wgmma"
    assert M % K.LINEAR_TF32_WGMMA_ROWS == 0 and N % K.LINEAR_TF32_WGMMA_COLS == 0
    assert K_ % 64 == 0 and K_ % K.LINEAR_TF32_WGMMA_K == 0


# (M, K, N, w_bf16, round_a, aligned) -> route: a bf16 W, round_a, ragged
# strides (the denoiser's K 702 and the head's N 9) and rows off 16 bytes
# stay on mma.sync; any row count takes TF32 wgmma otherwise (few rows with
# trans_w, the f32 serving ViT's N 384 at 20 frames: 126 tiles, a single
# tile)
ROUTE_TABLE = [
    (135168, 384, 1152, False, False, True, "tf32_wgmma"),
    (135168, 384, 1152, True, False, True, "tf32_mma"),
    (135168, 384, 1152, False, True, True, "tf32_mma"),
    (135168, 384, 1152, True, True, True, "bf16_wgmma"),
    (135168, 384, 1152, False, False, False, "tf32_mma"),
    (46080, 702, 512, False, False, True, "tf32_mma"),
    (46080, 128, 9, False, False, True, "tf32_mma"),
    (46080, 130, 512, False, False, True, "tf32_mma"),
    (46080, 512, 514, False, False, True, "tf32_mma"),
    (40, 384, 1536, False, False, True, "tf32_wgmma"),
    (5280, 384, 384, False, False, True, "tf32_wgmma"),
    (5280, 384, 1152, False, False, True, "tf32_wgmma"),
    (4224, 512, 512, False, False, True, "tf32_wgmma"),
    (4000, 512, 512, False, False, True, "tf32_wgmma"),
    (128, 384, 128, False, False, True, "tf32_wgmma"),
    (5281, 200, 392, False, False, True, "tf32_wgmma"),
    (100, 36, 17000, False, False, True, "tf32_wgmma"),
    (135168, 0, 384, False, False, True, "tf32_mma"),
]


@pytest.mark.parametrize("M,K_,N,w_bf16,round_a,aligned,route", ROUTE_TABLE)
def test_route_table(M, K_, N, w_bf16, round_a, aligned, route):
    assert K.linear_route(K_, N, w_bf16, round_a, aligned) == route


LINEAR_CU = Path(K.__file__).resolve().parents[1] / "csrc" / "linear.cu"


def test_route_and_tile_mirror_the_kernel():
    """The tile constants and the route codes hold what csrc/linear.cu
    holds (a card test compares pd_linear_route with kernels.linear_route,
    and the shared memory)."""
    src = LINEAR_CU.read_text()
    assert "constexpr int TW_BK = 32;" in src and K.LINEAR_TF32_WGMMA_K == 32
    assert "constexpr int TW_EPI_COLS = 32;" in src and K.LINEAR_TF32_WGMMA_EPI_COLS == 32
    assert "static constexpr int BM = 128, BN = 128;" in src
    assert K.LINEAR_TF32_WGMMA_ROWS == K.LINEAR_TF32_WGMMA_COLS == 128
    assert re.search(r"struct Tw \{[^}]*static constexpr int STAGES = 4;", src)
    assert K.LINEAR_TF32_WGMMA_STAGES == 4
    codes = re.search(r"enum \{ ROUTE_TF32_MMA = 0, ROUTE_TF32_WGMMA = 1, ROUTE_BF16_WGMMA = 2 \};",
                      src)
    assert codes and K.LINEAR_ROUTES == ("tf32_mma", "tf32_wgmma", "bf16_wgmma")


def test_wgmma_tile_shared_memory_worked_by_hand():
    """4 slots of 48 KB (a, W's hi, W's lo: 16 KB each), two epilogue
    buffers of 64 x 40 floats, 8 barriers, 1,024 bytes of slack: under the
    232,448 bytes a Hopper block may use, and a fifth slot would not fit;
    slots and their parts on 1,024-byte swizzle atoms."""
    smem = K.linear_tf32_wgmma_smem_bytes()
    assert smem == 1024 + 4 * 3 * 16384 + 2 * 64 * 40 * 4 + 8 * 8 == 218176
    assert smem <= 232448 < smem + 3 * 16384
    assert 16384 % 1024 == 0


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


# the ViT-g cell's trunk (96 x 348 rows: qkv, proj, w12 and w3)
VITG_SHAPES = [(96 * 348, k, n) for k, n in ((1536, 4608), (1536, 1536), (1536, 8192),
                                              (4096, 1536))]


@pytest.mark.parametrize("M,K_,N", VITG_SHAPES)
def test_wgrad_split_fills_the_card_at_vitg(M, K_, N):
    """The same at ViT-g's widths: w12 (768 tiles) and w3 (384) run one
    split of all 33,408 rows in near-whole waves; qkv and proj split."""
    test_wgrad_split_fills_the_card(M, K_, N)
    want = {8192: 33408, 1536: 33408 if K_ == 4096 else 4176, 4608: 11136}[N]
    assert K.wgrad_rows(M, K_, N) == want


# (rows, K, N) of the float32 train weight gradients of all three cells, the
# ViT-g cell's encoder (6 x 90 x 16 rows) included
CELL_WGRADS = PATH_SHAPES + VITG_SHAPES + [
    (8640, k, n) for k, n in ((512, 1536), (512, 512), (512, 1024), (1024, 512))]


@pytest.mark.parametrize("M,K_,N", CELL_WGRADS)
def test_cell_weight_gradients_take_the_wgmma_route(M, K_, N):
    """Every float32 train weight gradient of the three cells is one TMA can
    address: it goes to TF32 wgmma (the operands are whole contiguous
    tensors, on the allocator's 512-byte boundaries); bf16 mode to bf16
    wgmma. Both split the rows alike, each row in exactly one split."""
    assert wgrad_route(K_, N, False) == "tf32_wgmma"
    assert wgrad_route(K_, N, True) == "bf16_wgmma"
    rows = K.wgrad_rows(M, K_, N)
    assert rows == K.wgrad_rows(M, K_, N, True)
    splits = -(-M // rows)
    assert splits * rows >= M and (splits - 1) * rows < M
    assert splits <= -(-M // 1024)
    assert -(-K_ // 128) * -(-N // 128) * splits >= 132


def wgrad_route(K_: int, N: int, round_in: bool, aligned: bool = True) -> str:
    """The route csrc/linear.cu wgrad_route gives ``linear_wgrad`` (the
    wrapper asks pd_linear_wgrad_route; test_wgrad_route_and_tile_mirror_the_kernel
    holds this to the source, a card test to the library): ``bf16_wgmma``
    in bf16 mode; ``tf32_wgmma`` for float32 operands whose rows TMA can
    address (``aligned``: x and dy on 16-byte boundaries; K and N multiples
    of 4); ``tf32_mma`` for the rest."""
    if round_in:
        return "bf16_wgmma"
    if aligned and K_ % 4 == 0 and N % 4 == 0:
        return "tf32_wgmma"
    return "tf32_mma"


# (K, N, round_in, aligned) -> route: K or N off 4 or a base off 16 bytes
# fall back to mma.sync in float32 mode; bf16 mode takes any
WGRAD_ROUTE_TABLE = [
    (384, 1536, False, True, "tf32_wgmma"),
    (132, 68, False, True, "tf32_wgmma"),
    (4, 4, False, True, "tf32_wgmma"),
    (130, 70, False, True, "tf32_mma"),
    (384, 70, False, True, "tf32_mma"),
    (702, 512, False, True, "tf32_mma"),
    (384, 256, False, False, "tf32_mma"),
    (384, 256, True, True, "bf16_wgmma"),
    (130, 70, True, False, "bf16_wgmma"),
]


@pytest.mark.parametrize("K_,N,round_in,aligned,route", WGRAD_ROUTE_TABLE)
def test_wgrad_route_table(K_, N, round_in, aligned, route):
    assert wgrad_route(K_, N, round_in, aligned) == route


# wgrad_tf32_wgmma_kernel's tile (csrc/linear.cu struct Wt): a ring slot
# holds 32 data rows of X (128 columns, four 32 x 32-float boxes) and of dY
# (128 columns); two buffers hold dY's TF32 hi and lo halves transposed
WGRAD_TF32_SLICE, WGRAD_TF32_STAGES, WGRAD_TF32_BUFS = 32, 5, 2
# its shared memory, worked by hand below (the card test holds
# pd_linear_wgrad_tf32_smem_bytes to it)
WGRAD_TF32_SMEM = 230512


def test_wgrad_route_and_tile_mirror_the_kernel():
    """wgrad_route and the tile's constants hold what csrc/linear.cu holds (a
    card test compares pd_linear_wgrad_route and the shared memory)."""
    src = LINEAR_CU.read_text()
    body = re.search(r"int wgrad_route\(int K, int N, int round_in, int x_aligned, "
                     r"int dy_aligned\) \{(.*?)\n\}", src, re.S).group(1)
    assert "if (round_in) return ROUTE_BF16_WGMMA;" in body
    assert "if (x_aligned && dy_aligned && K % 4 == 0 && N % 4 == 0) return ROUTE_TF32_WGMMA;" \
        in body
    assert "return ROUTE_TF32_MMA;" in body
    assert f"constexpr int WT_SLICE = {WGRAD_TF32_SLICE};" in src
    assert "constexpr int WT_GROUP = 2;" in src
    assert re.search(rf"struct Wt \{{[^}}]*static constexpr int STAGES = {WGRAD_TF32_STAGES};",
                     src)
    assert re.search(rf"struct Wt \{{[^}}]*static constexpr int BUFS = {WGRAD_TF32_BUFS};", src)
    assert "static constexpr int TILE = 128;" in src and K.WGRAD_TILE[False] == 128


def test_wgrad_tile_shared_memory_worked_by_hand():
    """5 slots of 32 KB (X's and dY's 32 x 128 floats), two buffers of dY's
    hi and lo halves (16 KB each), 14 barriers, 1,024 bytes of slack: under
    the 232,448 bytes a Hopper block may use, and a sixth slot or a third
    buffer would not fit; slots, boxes and halves on 1,024-byte swizzle
    atoms."""
    tile = K.WGRAD_TILE[False]
    slot = 2 * WGRAD_TF32_SLICE * tile * 4
    buf = 2 * tile * WGRAD_TF32_SLICE * 4
    smem = (1024 + WGRAD_TF32_STAGES * slot + WGRAD_TF32_BUFS * buf
            + 2 * (WGRAD_TF32_STAGES + WGRAD_TF32_BUFS) * 8)
    assert smem == 1024 + 5 * 32768 + 2 * 2 * 16384 + 14 * 8 == WGRAD_TF32_SMEM
    assert smem <= 232448 < smem + 32768
    assert 32768 % 1024 == 0 and 4096 % 1024 == 0 and 16384 % 1024 == 0


def _wgrad_wgmma_chain(x: torch.Tensor, dy: torch.Tensor, rows: int) -> torch.Tensor:
    """x^T dy as wgrad_tf32_wgmma_kernel and sum_partials sum it: per split
    of ``rows`` rows, 32-row slots of four k8 wgmma steps (zeros past the
    split), each running lo.hi, hi.lo and hi.hi into one accumulator that
    truncates its sums, zeroed (scale-d 0) at the first step of every
    other slot and added, rounded to nearest, into the split's running sum
    after every second slot and after the last; then the splits' partials
    added in order in float32. A k8 step's eight depths are data rows in
    another order than the rows' (8 kk + 2t and + 1): its eight products
    are exact, so their sum does not depend on it."""
    M = x.shape[0]
    out = None
    for r0 in range(0, M, rows):
        (xh, xl), (dh, dl) = _split(x[r0:r0 + rows].t()), _split(dy[r0:r0 + rows])
        n = xh.shape[1]
        acc = torch.zeros(x.shape[1], dy.shape[1])
        part = None
        slots = -(-n // 32)
        for q in range(slots):
            for kk in range(4):
                ks = slice(min(n, 32 * q + 8 * kk), min(n, 32 * q + 8 * kk + 8))
                for i, (a, b) in enumerate(((xl, dh), (xh, dl), (xh, dh))):
                    prod = a[:, ks].double() @ b[ks].double()
                    zero = i == 0 and kk == 0 and q % 2 == 0
                    part = _rz(prod if zero else part.double() + prod)
            if q % 2 == 1 or q == slots - 1:
                acc = acc + part
        out = acc if out is None else out + acc
    return out


# (M, K, N, rows a split): one split of 4,096 rows; three splits whose
# boundaries fall inside slots; a split under one group
@pytest.mark.parametrize("M,K_,N,rows", [(4096, 64, 96, 4096), (3001, 96, 64, 1001),
                                         (1100, 32, 64, 1056)])
def test_wgrad_wgmma_accumulation_holds_float64(M, K_, N, rows):
    """The wgmma tile's order (a fresh accumulator per 64 rows) stays near
    float32's own rounding over thousands of rows; one truncating
    accumulator over the same 4,096 rows drifts past 1e-5."""
    r = np.random.default_rng(M + K_)
    x = torch.tensor(r.normal(size=(M, K_)).astype(np.float32))
    dy = torch.tensor(r.normal(size=(M, N)).astype(np.float32))
    ref = x.double().t() @ dy.double()
    out = _wgrad_wgmma_chain(x, dy, rows)
    assert _rel(out.double(), ref) <= TOL / 10, _rel(out.double(), ref)
    if M == rows:
        running = _rel(_mma_chain(x.t(), dy, 0).double(), ref)
        assert running > TOL, running


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
