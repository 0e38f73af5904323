"""The few-rows route of ``linear`` and the LayerNorm folded into it, on
the CPU (the plain route): the fold computes what the separate LayerNorm
and product compute, bitwise; a folded layer agrees with the JAX package's
``encoder_layer_math``; a sampler-sized layer is five calls, a sampler step
2 + 5 L; the launch geometry gives every SM of the card a block at the
sampler's four product shapes.

Inputs are drawn with numpy from fixed seeds. The JAX comparison runs the
pure layer math (posediffusion_tpu/ops/denoiser_kernel.py:42) outside any
Pallas call: float32 sums in another order, held to 1e-5 relative to
max(1, |ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.ops.denoiser_kernel import encoder_layer_math as jax_layer_math
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops.denoiser_kernel import encoder_layer_math

TOL = 1e-5
# the sampler's products per layer (d_model 512, FF 1,024): in_proj,
# out_proj, linear1, linear2 as (K, N)
SAMPLER_SHAPES = [(512, 1536), (512, 512), (512, 1024), (1024, 512)]


class Recorder:
    """An ``ops`` namespace that records (wrapper, ln given) per call and
    forwards to the plain versions."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(K.PLAIN, name)

        def call(*args, **kwargs):
            self.calls.append((name, kwargs.get("ln") is not None))
            return fn(*args, **kwargs)

        return call


def _bf16(a):
    """numpy float32 -> (the bf16-rounded float32 numpy array, a bf16 torch tensor)."""
    t = torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


def _layer_weights(r, D, F, wdtype):
    """Weights of one pre-norm layer in encoder_layer_math's order, as
    (numpy for JAX, torch for the port); matrices rounded to bf16 when asked."""
    shapes = [("g", D), ("v", D), ("w", (D, 3 * D)), ("v", 3 * D), ("w", (D, D)), ("v", D),
              ("g", D), ("v", D), ("w", (D, F)), ("v", F), ("w", (F, D)), ("v", D)]
    np_ws, t_ws = [], []
    for kind, shape in shapes:
        if kind == "g":
            a = (1 + 0.1 * r.normal(size=shape)).astype(np.float32)
        elif kind == "v":
            a = (0.1 * r.normal(size=shape)).astype(np.float32)
        else:
            a = (r.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
        if kind == "w" and wdtype == "bfloat16":
            a, t = _bf16(a)
        else:
            t = torch.tensor(a)
        np_ws.append(a)
        t_ws.append(t)
    return np_ws, t_ws


@pytest.mark.parametrize("act", ["none", "relu", "gelu"])
@pytest.mark.parametrize("round_a", [False, True])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_linear_plain_ln_is_layernorm_then_linear(act, round_a, wdtype, with_residual):
    """linear_plain(ln=...) is layernorm_plain(round_out=round_a) followed
    by linear_plain, bitwise: the fold keeps the TPU kernels' rounding sites."""
    r = np.random.default_rng(1)
    M, Kk, N = 20, 64, 48
    a = torch.tensor(r.normal(size=(M, Kk)) * 3 + 1, dtype=torch.float32)
    w = torch.tensor(r.normal(size=(Kk, N)) / 8, dtype=torch.float32).to(wdtype)
    b = torch.tensor(r.normal(size=N), dtype=torch.float32)
    g = torch.tensor(1 + 0.1 * r.normal(size=Kk), dtype=torch.float32)
    beta = torch.tensor(0.1 * r.normal(size=Kk), dtype=torch.float32)
    res = torch.tensor(r.normal(size=(M, N)), dtype=torch.float32) if with_residual else None
    folded = K.linear(a, w, b, act, res, round_a, ln=(g, beta, 1e-5))
    apart = K.linear_plain(K.layernorm_plain(a, g, beta, 1e-5, round_a), w, b, act, res, round_a)
    assert torch.equal(folded, apart)
    assert torch.equal(K.linear_rows(a, w, b, act, res, round_a, ln=(g, beta, 1e-5)), apart)


@pytest.mark.parametrize("rows", [20, 33])
@pytest.mark.parametrize("act_bf16", [False, True])
def test_fold_changes_no_bit(rows, act_bf16):
    """The layer with its LayerNorms folded (at most 32 rows) equals the
    seven-call layer, bitwise, on the plain route."""
    r = np.random.default_rng(2)
    D, F = 64, 128
    _, ws = _layer_weights(r, D, F, "bfloat16")
    x = torch.tensor(r.normal(size=(rows, D)), dtype=torch.float32)
    kb = torch.zeros(1, rows)
    out = encoder_layer_math(x, *ws, nhead=4, seq_len=rows, act_bf16=act_bf16, key_bias=kb)
    g1, b1, wqkv, bqkv, wout, bout, g2, b2, wl1, bl1, wl2, bl2 = ws
    P = K.PLAIN
    qkv = P.linear(P.layernorm(x, g1, b1, 1e-5, act_bf16), wqkv, bqkv, round_a=act_bf16)
    att = P.attention(qkv.view(1, rows, -1), 4, key_bias=kb, round_in=act_bf16)
    x1 = P.linear(att.reshape(rows, -1), wout, bout, residual=x, round_a=act_bf16)
    h = P.linear(P.layernorm(x1, g2, b2, 1e-5, act_bf16), wl1, bl1, act="relu",
                 round_a=act_bf16)
    assert torch.equal(out, P.linear(h, wl2, bl2, residual=x1, round_a=act_bf16))


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [0, 3])
def test_folded_layer_matches_jax(wdtype, masked):
    """20 rows (the sampler's frames), D 64, 4 heads, FF 128: the port's
    layer through ``KERNELS`` on the CPU, LayerNorms folded into the
    products, against the JAX ``encoder_layer_math``."""
    r = np.random.default_rng(3)
    rows, D, F = 20, 64, 128
    np_ws, t_ws = _layer_weights(r, D, F, wdtype)
    x = r.normal(size=(rows, D)).astype(np.float32)
    bias = np.zeros(rows, np.float32)
    if masked:
        bias[-masked:] = K.NEG
    ref = np.asarray(jax_layer_math(
        jnp.asarray(x), jnp.asarray(bias),
        *[jnp.asarray(w, jnp.bfloat16) if w.ndim == 2 and wdtype == "bfloat16" else jnp.asarray(w)
          for w in np_ws], nhead=4, d_model=D))
    rec = Recorder()
    encoder_layer_math(torch.tensor(x), *t_ws, nhead=4, seq_len=rows,
                       key_bias=torch.tensor(bias)[None], ops=rec)
    assert ("layernorm", False) not in rec.calls
    out = encoder_layer_math(torch.tensor(x), *t_ws, nhead=4, seq_len=rows,
                             key_bias=torch.tensor(bias)[None]).numpy()
    assert np.abs(out - ref).max() <= TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("rows,calls", [
    (1, [("linear", True), ("attention", False), ("linear", False), ("linear", True),
         ("linear", False)]),
    (20, [("linear", True), ("attention", False), ("linear", False), ("linear", True),
          ("linear", False)]),
    (32, [("linear", True), ("attention", False), ("linear", False), ("linear", True),
          ("linear", False)]),
    (33, [("layernorm", False), ("linear", False), ("attention", False), ("linear", False),
          ("layernorm", False), ("linear", False), ("linear", False)]),
])
def test_layer_route(rows, calls):
    """Five calls a layer and no layernorm up to 32 rows (ln on the QKV and
    first FF products); the seven calls above."""
    r = np.random.default_rng(4)
    _, ws = _layer_weights(r, 64, 128, "bfloat16")
    rec = Recorder()
    encoder_layer_math(torch.tensor(r.normal(size=(rows, 64)), dtype=torch.float32), *ws,
                       nhead=4, seq_len=rows, key_bias=torch.zeros(1, rows), ops=rec)
    assert rec.calls == calls


@pytest.mark.parametrize("B,N,per_step", [(1, 20, 1 + 5 * 2), (2, 12, 1 + 5 * 2),
                                          (3, 12, 1 + 7 * 2)])
def test_sampler_step_calls(B, N, per_step):
    """A sampler step is 1 + 5 L calls (41 at L = 8: the layers and the
    boundary into the next step, the epilogue at the last), plus step 0's
    prologue, while its B N rows take the few-rows route, 1 + 7 L above (a
    batched eval), and none of them is a layernorm in the first case."""
    from posediffusion_tpu_torch.diffusion.schedule import make_schedule
    from posediffusion_tpu_torch.models.denoiser import Denoiser
    from posediffusion_tpu_torch.models.pose_diffusion import init_random_weights
    from posediffusion_tpu_torch.ops.sampler_kernel import prepare_sampler, run_sampler

    den = Denoiser(z_dim=16, d_model=64, nhead=2, num_encoder_layers=2, dim_feedforward=96)
    init_random_weights(den, 5)
    steps = 3
    z = torch.tensor(np.random.default_rng(6).normal(size=(B, N, 16)), dtype=torch.float32)
    inp = prepare_sampler(den, make_schedule(timesteps=steps), z,
                          generator=torch.Generator().manual_seed(0))
    rec = Recorder()
    with torch.no_grad():
        out = run_sampler(inp, ops=rec)
        ref = run_sampler(inp, ops=K.PLAIN)
    assert len(rec.calls) == steps * per_step + 1
    assert (sum(name == "layernorm" for name, _ in rec.calls) == 0) == (B * N <= 32)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("K_,N", SAMPLER_SHAPES)
def test_rows_geometry_fills_the_card(K_, N):
    """Python picks the column tile: the tiles cover every column, and the
    (column tiles x 8 K slices) blocks give each of the 132 SMs one."""
    tile = K.linear_rows_tile(N)
    assert tile in (16, 32, 64)
    tiles = -(-N // tile)
    assert tiles * tile >= N > (tiles - 1) * tile
    assert tiles * K.LINEAR_ROWS_CLUSTER >= 132
    # each of the cluster's blocks gets a non-empty, 4-aligned slice of K
    slice_ = (-(-K_ // K.LINEAR_ROWS_CLUSTER) + 3) // 4 * 4
    assert slice_ * (K.LINEAR_ROWS_CLUSTER - 1) < K_ <= K.LINEAR_ROWS_LN_MAX_K


def test_plain_route_refuses_nothing_the_card_takes():
    """On the CPU, ``linear`` with ln at any row count is the plain
    composition (the row limit is the card route's)."""
    r = np.random.default_rng(7)
    a = torch.tensor(r.normal(size=(40, 16)), dtype=torch.float32)
    w = torch.tensor(r.normal(size=(16, 8)), dtype=torch.float32)
    ln = (torch.ones(16), torch.zeros(16), 1e-5)
    assert torch.equal(K.linear(a, w, None, ln=ln),
                       K.linear_plain(K.layernorm_plain(a, *ln), w, None))
