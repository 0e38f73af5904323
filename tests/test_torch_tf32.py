"""Why the train backward's tensor-core kernels take three TF32 products, and
the launch arithmetic they share with their Python wrappers, on the CPU.

``linear_wgrad`` (csrc/linear.cu, wgrad_tf32_kernel) and ``attention_bwd``
(csrc/attention_bwd.cu) run their float32 products as 3xTF32 MMAs: each
operand x splits into hi = tf32(x) (round to nearest at 10 mantissa bits,
cvt.rna) and lo = x - hi, which the tensor core truncates to TF32, and a
product is hi.hi + hi.lo + lo.hi. The emulation here (products of the TF32
values exact in float64) shows that this lands within 1e-5 of float64 on the
path's products, the card tests' float32 tolerance, and that one TF32
product (hi.hi alone) does not.
"""

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
    """Few rows: as many splits as 1,024-row ranges allow; bf16 mode's 64 x
    64 tile asks about four blocks an SM. Every row in exactly one split."""
    rows = K.wgrad_rows(M, K_, N, round_in)
    splits = -(-M // rows)
    assert splits * rows >= M and (splits - 1) * rows < M
    assert splits <= max(1, -(-M // 1024))
    if round_in:
        tiles = -(-K_ // 64) * -(-N // 64)
        assert splits == max(1, min(-(-M // 1024), -(-4 * 132 // tiles)))


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
