"""The bf16 route of ``linear`` and the LayerNorm forward, on the CPU.

``linear`` with a bf16 W and ``round_a`` runs on bf16 ``wgmma`` on the card
(csrc/linear.cu, linear_bf16_wgmma_kernel): 128 x 128 tiles on a persistent
grid, a shared-memory ring whose size Python mirrors
(``kernels.linear_bf16_smem_bytes``). Here: the tiles and waves at the
serving ViTs' shapes as ``kernels`` tabulates them, the ring's fit, and,
with the tensor core's truncating float32 accumulation emulated, why each
64-wide K slice goes into a fresh accumulator. Then the plain LayerNorm
against the JAX kernels' ``_layer_norm``, with the bf16 cast of the serving
ViT.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posediffusion_tpu.ops.vit_kernel import _layer_norm as jax_layer_norm
from posediffusion_tpu_torch.ops import kernels as K

TOL = 1e-5  # tests/test_torch_cuda.py TOL_F32: kernel against plain, float32
SMS = 132


def _table():
    """{(M, K, N): (tiles, waves)} from the table in ops/kernels.py's
    comment above LINEAR_BF16_ROWS (a row's M is the last one written)."""
    src = inspect.getsource(K)
    block = src[src.index("# csrc/linear.cu linear_bf16_wgmma_kernel"):
                src.index("LINEAR_BF16_ROWS = ")]
    rows, M = {}, None
    for line in block.splitlines():
        m = re.match(r"#\s+([\d,]+)?\s*(?:\(\w+\)|ViT-B)?\s+([\d,]+) -> ([\d,]+)"
                     r"\s+([\d,]+)\s+(\d+)", line)
        if m:
            num = lambda t: int(t.replace(",", ""))  # noqa: E731
            M = num(m.group(1)) if m.group(1) else M
            rows[(M, num(m.group(2)), num(m.group(3)))] = (num(m.group(4)), num(m.group(5)))
    return rows


# the serving ViT-S/16 at 224px (20 x 264 tokens) and 336px (20 x 593),
# ViT-B/16 at 224px: every product of a block
PATH = [(m, k, n) for m in (5280, 11860)
        for k, n in ((384, 1152), (384, 384), (384, 1536), (1536, 384))] + \
    [(5280, k, n) for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768))]


@pytest.mark.parametrize("M,K_,N", PATH)
def test_path_shapes_take_the_documented_tiles(M, K_, N):
    """Every path shape is in the comment's table with the tiles and waves
    the kernel's grid gives it (128 x 128 tiles, one block an SM)."""
    tiles = -(-M // K.LINEAR_BF16_ROWS) * -(-N // K.LINEAR_BF16_COLS)
    assert _table()[(M, K_, N)] == (tiles, -(-tiles // SMS))


def test_the_table_lists_only_the_path():
    assert sorted(_table()) == sorted(PATH)


def test_every_instance_fits_shared_memory():
    """Both instances (W (K, N) and W (N, K)) share one layout: three ring
    slots and the epilogue buffers under the 232,448 bytes a Hopper block
    may use, and a fourth slot would not fit; slots on 1,024-byte swizzle
    atoms."""
    smem = K.linear_bf16_smem_bytes()
    stage = 128 * 64 * 4 + 64 * 128 * 2
    assert stage % 1024 == 0
    assert smem <= 232448 < smem + stage + 16


def test_shared_memory_worked_by_hand():
    """3 slots of 48 KB (a 32 KB, W 16 KB), 128 x 132 floats of epilogue,
    6 barriers."""
    assert K.linear_bf16_smem_bytes() == 1024 + 3 * 49152 + 128 * 132 * 4 + 6 * 8


# ---- the tensor core's accumulation (the card test
# test_bf16_tensor_core_accumulation_truncates shows it truncates)
def _rz(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero (the tensor core's accumulator)."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _wgmma_chain(a: torch.Tensor, w: torch.Tensor, slice_k: int) -> torch.Tensor:
    """a @ w (bf16 values) as a chain of k16 MMAs: each adds its sixteen
    exact products to the accumulator and truncates the sum to float32.
    With ``slice_k`` each slice of K goes into a fresh accumulator added to
    the running sum rounded to nearest (the kernel's design); with 0 one
    accumulator runs over the whole of K."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    tmp = torch.zeros_like(acc)
    ad, wd = a.double(), w.double()
    for k0 in range(0, a.shape[1], 16):
        tmp = _rz(tmp.double() + ad[:, k0:k0 + 16] @ wd[k0:k0 + 16])
        if slice_k and (k0 + 16) % slice_k == 0:
            acc, tmp = acc + tmp, torch.zeros_like(tmp)
    return acc + tmp


def _rel(out, ref):
    return ((out.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("K_,N", [(3072, 768), (1536, 384)])
def test_a_fresh_accumulator_per_slice_keeps_float32_accuracy(K_, N):
    """ViT-B's fc2 (K 3,072) and ViT-S's (K 1,536), bf16 operands: a fresh
    accumulator per 64-wide slice stays at float32's own rounding (within
    2x of a float32 product summed to nearest, under 1e-6 of float64); one
    accumulator over the whole of K drifts 10x and more past that, towards
    the card tests' 1e-5 (a bias that grows with K)."""
    r = np.random.default_rng(K_)
    a = K.round_bf16(torch.tensor(r.normal(size=(256, K_)).astype(np.float32)))
    w = K.round_bf16(torch.tensor((r.normal(size=(K_, N)) / np.sqrt(K_)).astype(np.float32)))
    ref = a.double() @ w.double()
    sliced = _rel(_wgmma_chain(a, w, 64), ref)
    running = _rel(_wgmma_chain(a, w, 0), ref)
    plain = _rel(a @ w, ref)
    assert sliced <= TOL / 10 and sliced <= 2 * plain, (sliced, plain)
    assert running > 10 * sliced, (running, sliced)
    assert running <= TOL, running


def test_rounding_probe_of_the_card_test():
    """The card test's row: 1 + 0.75 ulp(1) (two bf16 products in one
    slice) is 1 when the accumulation truncates and 1 + 2^-23 when it
    rounds to nearest; the plain version rounds to nearest."""
    a = torch.zeros(1, 32)
    a[0, 0], a[0, 16] = 1.0, 1.5 * 2.0**-24
    w = torch.ones(32, 8, dtype=torch.bfloat16)
    assert _wgmma_chain(a, w.float(), 64)[0, 0].item() == 1.0
    assert K.linear_plain(a, w, None, round_a=True)[0, 0].item() == 1.0 + 2.0**-23


# ---- the LayerNorm forward's plain version against the TPU kernels'
@pytest.mark.parametrize("D", [384, 768, 1536])
@pytest.mark.parametrize("round_out", [False, True])
def test_layernorm_plain_matches_the_jax_kernels(D, round_out):
    """posediffusion_tpu/ops/vit_kernel.py _layer_norm (eps 1e-6), then the
    bf16 cast of the serving ViT's bf16 mode (cast(_layer_norm(x, g1, b1)))
    when round_out; D 1,536 is a row wider than the card's register
    instances (the strided one)."""
    r = np.random.default_rng(D)
    x = (r.normal(size=(64, D)) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * r.normal(size=D)).astype(np.float32)
    b = (0.1 * r.normal(size=D)).astype(np.float32)
    ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-6)
    if round_out:
        ref = ref.astype(jnp.bfloat16).astype(jnp.float32)
    out = K.layernorm(torch.tensor(x), torch.tensor(g), torch.tensor(b), 1e-6, round_out)
    ref = np.asarray(ref)
    if round_out:  # one bf16 ulp where float32 sums in another order cross a rounding
        diff = np.abs(out.numpy() - ref)
        assert (diff > 1e-6).mean() < 1e-3
        assert diff.max() <= 2.0**-7 * max(1.0, np.abs(ref).max())
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-6)


def test_layernorm_counts_launches_by_shape_on_the_card_only():
    """The CPU route is the plain version: no launch, no shape counted."""
    K.reset_launch_counts()
    x = torch.randn(5, 384)
    K.layernorm(x, torch.ones(384), torch.zeros(384), 1e-6)
    assert K.launch_counts()["layernorm"] == 0 and K.layernorm.by_shape == {}
