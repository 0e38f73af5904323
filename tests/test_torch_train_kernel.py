"""The port's train trunks (TPU kernels 9 and 10) on the CPU.

* the plain train trunks against the JAX package's ``fused_vit_trunk_train``
  and ``fused_encoder_trunk_train`` run in interpret mode, at dropout 0
  (Pallas has no CPU lowering of the TPU PRNG): outputs, the input gradient
  and every weight gradient, f32 and bf16-residual modes, with the JAX
  kernel tests' own tolerances (tests/test_vit_train_kernel.py:71,90,180);
* the hand-derived backward against ``torch.autograd`` of the plain forward,
  with dropout 0.1 masks from the port's generator: the only place where
  dropout above 0 is checked on the CPU (the ViT with DINOv2's LayerScale
  gains too);
* the plain versions of the new kernels against autograd;
* the dropout masks' statistics.

Sizes: depth 2, D 64, 2 heads, N 20 tokens with a packing or key bias, B 6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.ops import vit_train_kernel as JV
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops.vit_train_kernel import (
    LS_KEYS,
    WEIGHT_KEYS,
    TrunkSpec,
    fused_encoder_trunk_train,
    fused_vit_trunk_train,
    train_trunk,
    trunk_reference,
)

L, D, H, N, B = 2, 64, 2, 20, 6
NEG = K.NEG


def random_stacks(rng, depth=L, d=D, f=4 * D):
    """float32 stacks in the port's layout ((L, in, out) matrices, (L, d)
    vectors), drawn as tests/test_torch_models.random_params draws."""
    shapes = {"g1": (d,), "b1": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wproj": (d, d), "bproj": (d,), "g2": (d,), "b2": (d,),
              "wfc1": (d, f), "bfc1": (f,), "wfc2": (f, d), "bfc2": (d,)}
    out = {}
    for k in WEIGHT_KEYS:
        n = rng.normal(size=(depth,) + shapes[k]).astype(np.float32)
        if k.startswith("w"):
            out[k] = n / np.sqrt(shapes[k][0])
        elif k.startswith("g"):
            out[k] = 1.0 + 0.1 * n
        else:
            out[k] = 0.1 * n
    return out


def jax_stacks(stacks):
    """The JAX kernel's layout: vectors (L, 1, d)."""
    return {k: jnp.asarray(v[:, None, :] if v.ndim == 2 else v) for k, v in stacks.items()}


def packing_bias():
    """Two packed segments of 12 and 8 tokens (block-diagonal, NEG across)."""
    seg = np.array([0] * 12 + [1] * 8)
    return np.where(seg[:, None] == seg[None, :], 0.0, NEG).astype(np.float32)


def key_bias(rng):
    """(B, N) frame mask: the last frames of some rows padded away."""
    valid = np.arange(N)[None, :] < rng.integers(N // 2, N + 1, size=(B, 1))
    return np.where(valid, 0.0, NEG).astype(np.float32)


def _jax_grads(flavor, x, stacks, bias, r, act_bf16=False, bf16_res=False):
    jst = jax_stacks(stacks)

    def loss(xx, st):
        if bf16_res:
            xx = xx.astype(jnp.bfloat16)
        if flavor == "vit":
            y = JV.fused_vit_trunk_train(xx, st, jnp.asarray(bias), H, 2, 1,
                                         act_bf16, True)
        else:
            y = JV.fused_encoder_trunk_train(xx, st, jnp.asarray(bias),
                                             jnp.zeros((1,), jnp.int32), H, 2, 1,
                                             act_bf16, 0.0, True)
        y = y.astype(jnp.float32)
        return jnp.sum(y * r), y

    (val, y), (gx, gst) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        jnp.asarray(x), jst)
    gst = {k: np.asarray(v).reshape(stacks[k].shape) for k, v in gst.items()}
    return float(val), np.asarray(y), np.asarray(gx), gst


def _port_grads(flavor, x, stacks, bias, r, act_bf16=False, bf16_res=False,
                dropout=0.0, seed=0):
    xt = torch.tensor(x, requires_grad=True)
    st = {k: torch.tensor(v, requires_grad=True) for k, v in stacks.items()}
    if flavor == "vit":
        y = fused_vit_trunk_train(xt, st, torch.tensor(bias), H, act_bf16, bf16_res)
    elif flavor == "vit_ls":  # DINOv2's gains, with the encoder's dropout sites
        y = train_trunk(xt, st, _spec(flavor, dropout, seed), attn_bias=torch.tensor(bias))
    else:
        y = fused_encoder_trunk_train(xt, st, torch.tensor(bias), seed, H, act_bf16,
                                      bf16_res, dropout)
    val = (y * torch.tensor(r)).sum()
    val.backward()
    return (float(val.detach()), y.detach().numpy(), xt.grad.numpy(),
            {k: v.grad.numpy() for k, v in st.items()})


def _assert_grads(ours, ref, rel):
    for k in ref:
        scale = max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(ours[k], ref[k], atol=rel * scale, err_msg=k)


FLAVORS = ("vit", "encoder")


def _inputs(rng, flavor):
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    r = rng.normal(size=(B, N, D)).astype(np.float32)
    bias = key_bias(rng) if flavor == "encoder" else packing_bias()
    stacks = random_stacks(rng)
    if flavor == "vit_ls":
        for k in LS_KEYS:
            stacks[k] = (1.0 + 0.1 * rng.normal(size=(L, D))).astype(np.float32)
    return x, stacks, bias, r


def _spec(flavor, dropout, seed):
    vit = flavor != "encoder"
    return TrunkSpec(nhead=H, eps=1e-6 if vit else 1e-5, act="gelu" if vit else "relu",
                     dropout=dropout, seed=seed, layer_scale=flavor == "vit_ls")


class TestAgainstJax:
    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_f32_primal_and_grads(self, rng, flavor):
        x, stacks, bias, r = _inputs(rng, flavor)
        _, jy, jgx, jg = _jax_grads(flavor, x, stacks, bias, r)
        _, py, pgx, pg = _port_grads(flavor, x, stacks, bias, r)
        # the primal elementwise (a scalar sum of 7,680 signed terms would
        # measure float32 summation order, not the trunk)
        np.testing.assert_allclose(py, jy, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(jy).max()))
        np.testing.assert_allclose(pgx, jgx, atol=2e-5 * max(1.0, np.abs(jgx).max()))
        _assert_grads(pg, jg, 2e-5)

    @pytest.mark.parametrize("flavor", FLAVORS)
    def test_bf16_residuals(self, rng, flavor):
        """bf16 operands and bf16 residual stream (compute_dtype bfloat16).
        ViT: the JAX kernel test's 0.07 x scale (tests/test_vit_train_kernel.py
        :180). Encoder: a bf16 ULP that flips a ReLU's active set gives
        isolated O(contribution) jumps, so the JAX package guards its own
        encoder bf16 route statistically (:360-367). Here: at most 2% of
        elements beyond 0.05 x scale, a mean error within one bf16 ULP
        (2^-8) x scale, and the port no farther from the float32 gradients
        than the JAX kernel's bf16 route is (1.25x its mean error)."""
        x, stacks, bias, r = _inputs(rng, flavor)
        _, jy, jgx, jg = _jax_grads(flavor, x, stacks, bias, r, True, True)
        _, py, pgx, pg = _port_grads(flavor, x, stacks, bias, r, True, True)
        np.testing.assert_allclose(py, jy, atol=0.07 * max(1.0, np.abs(jy).max()))
        if flavor == "vit":
            np.testing.assert_allclose(pgx, jgx, atol=0.07 * max(1.0, np.abs(jgx).max()))
            _assert_grads(pg, jg, 0.07)
            return
        _, _, fgx, fg = _jax_grads(flavor, x, stacks, bias, r)

        def rel(ours, ref):
            out = [(np.abs(a - b) / max(1.0, float(np.abs(b).max()))).ravel()
                   for a, b in [(ours[0], ref[0])] + [(ours[1][k], ref[1][k]) for k in jg]]
            return np.concatenate(out)

        err = rel((pgx, pg), (jgx, jg))
        assert (err > 0.05).mean() <= 0.02
        assert err.mean() <= 2.0**-8
        assert rel((pgx, pg), (fgx, fg)).mean() <= 1.25 * rel((jgx, jg), (fgx, fg)).mean()

    def test_bf16_operands_f32_residuals(self, rng):
        """act_bf16 alone (JAX's test_bf16_grads_close setting): 0.05 x scale."""
        x, stacks, bias, r = _inputs(rng, "vit")
        _, _, jgx, jg = _jax_grads("vit", x, stacks, bias, r, True, False)
        _, _, pgx, pg = _port_grads("vit", x, stacks, bias, r, True, False)
        np.testing.assert_allclose(pgx, jgx, atol=0.05 * max(1.0, np.abs(jgx).max()))
        _assert_grads(pg, jg, 0.05)


class TestHandDerivedBackward:
    @pytest.mark.parametrize("flavor,dropout", [("vit", 0.0), ("encoder", 0.0),
                                                ("encoder", 0.1), ("vit_ls", 0.0),
                                                ("vit_ls", 0.1)])
    def test_matches_autograd_of_plain_forward(self, rng, flavor, dropout):
        """float32 on both sides, dropout masks from the port's generator:
        round-off only (1e-5 x scale). ``vit_ls``: the LayerScale gains'
        gradients from ``layerscale_bwd``, at the m1 / m2 sites' masks."""
        x, stacks, bias, r = _inputs(rng, flavor)
        _, py, pgx, pg = _port_grads(flavor, x, stacks, bias, r, dropout=dropout,
                                     seed=1234)
        xt = torch.tensor(x, requires_grad=True)
        st = {k: torch.tensor(v, requires_grad=True) for k, v in stacks.items()}
        spec = _spec(flavor, dropout, 1234)
        kw = ({"key_bias": torch.tensor(bias)} if flavor == "encoder"
              else {"attn_bias": torch.tensor(bias)})
        y = trunk_reference(xt, st, spec, **kw)
        (y * torch.tensor(r)).sum().backward()
        np.testing.assert_allclose(py, y.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(pgx, xt.grad.numpy(),
                                   atol=1e-5 * max(1.0, np.abs(pgx).max()))
        _assert_grads(pg, {k: v.grad.numpy() for k, v in st.items()}, 1e-5)

    def test_dropout_changes_the_output(self, rng):
        x, stacks, bias, r = _inputs(rng, "encoder")
        y0 = _port_grads("encoder", x, stacks, bias, r)[1]
        y1 = _port_grads("encoder", x, stacks, bias, r, dropout=0.1, seed=5)[1]
        y2 = _port_grads("encoder", x, stacks, bias, r, dropout=0.1, seed=5)[1]
        assert np.abs(y1 - y0).max() > 1e-2
        np.testing.assert_array_equal(y1, y2)


def _autograd(fn, inputs, cot):
    ins = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    out.backward(cot)
    return [t.grad for t in ins]


class TestPlainKernelBackwards:
    @pytest.mark.parametrize("round_in,drop,kind", [
        (False, None, "attn"), (False, 0.1, "key"), (False, None, "none")])
    def test_attention_bwd(self, rng, round_in, drop, kind):
        qkv = torch.tensor(rng.normal(size=(B, N, 3 * D)).astype(np.float32))
        dout = torch.tensor(rng.normal(size=(B, N, D)).astype(np.float32))
        kw = {"attn": {"attn_bias": torch.tensor(packing_bias())},
              "key": {"key_bias": torch.tensor(key_bias(rng))}, "none": {}}[kind]
        d = K.drop_args(9, 1, "attn", drop) if drop else None
        ours = K.attention_bwd(qkv, dout, H, round_in=round_in, drop=d, **kw)
        (ref,) = _autograd(lambda t: K.attention_plain(t, H, drop=d, **kw), [qkv], dout)
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=2e-6)

    def test_layernorm_bwd(self, rng):
        x = torch.tensor(rng.normal(size=(37, D)).astype(np.float32))
        g = torch.tensor(1 + 0.1 * rng.normal(size=D).astype(np.float32))
        b = torch.tensor(0.1 * rng.normal(size=D).astype(np.float32))
        dh = torch.tensor(rng.normal(size=(37, D)).astype(np.float32))
        res = torch.tensor(rng.normal(size=(37, D)).astype(np.float32))
        dx, dg, db = K.layernorm_bwd(x, g, dh, 1e-5, residual=res)
        rx, rg, rb = _autograd(lambda *t: K.layernorm_plain(*t, 1e-5), [x, g, b], dh)
        np.testing.assert_allclose(dx.numpy(), (rx + res).numpy(), atol=2e-5)
        np.testing.assert_allclose(dg.numpy(), rg.numpy(), atol=2e-5)
        np.testing.assert_allclose(db.numpy(), rb.numpy(), atol=2e-5)

    @pytest.mark.parametrize("act", ["relu", "gelu"])
    def test_linear_wgrad_dgrad_and_act_bwd(self, rng, act):
        a = torch.tensor(rng.normal(size=(29, D)).astype(np.float32))
        w = torch.tensor(rng.normal(size=(D, 48)).astype(np.float32) / 8)
        bias = torch.tensor(rng.normal(size=48).astype(np.float32))
        dy = torch.tensor(rng.normal(size=(29, 48)).astype(np.float32))
        d = K.drop_args(3, 0, "mff", 0.1)
        fwd = lambda a_, w_, b_: K.linear_plain(a_, w_, b_, act=act, drop=d)  # noqa: E731
        ra, rw, rb = _autograd(fwd, [a, w, bias], dy)
        _, pre = K.linear(a, w, bias, act=act, drop=d, want_pre=True)
        da = K.act_dropout_bwd(dy, pre, act, d)
        dw, db = K.linear_wgrad(a, da)
        dgrad = K.linear(da, w, None, trans_w=True)
        np.testing.assert_allclose(dw.numpy(), rw.numpy(), atol=1e-5)
        np.testing.assert_allclose(db.numpy(), rb.numpy(), atol=1e-5)
        np.testing.assert_allclose(dgrad.numpy(), ra.numpy(), atol=1e-5)

    @pytest.mark.parametrize("act", ["relu", "gelu"])
    @pytest.mark.parametrize("masked", [False, True])
    def test_act_dropout_bwd_plain_matches_mlp_residual_bwd(self, rng, act, masked):
        """act_dropout_bwd_plain against the JAX kernel body's own lines
        (``_mlp_residual_bwd``, posediffusion_tpu/ops/vit_train_kernel.py
        :330-340) at an odd element count (7 tokens x F 13 = 91, so a
        float4 pass has a tail), with and without the mff mask (the port's
        mask handed to the body as its mask array). The body's da1 is read
        back through the fc1 gradients it forms from it, hf^T da1 and
        colsum(da1): within 1e-5."""
        nt, d, f = 7, 8, 13
        nrm = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
        x1, dy = nrm(1, nt, d), nrm(1, nt, d)
        g2, b2 = 1 + 0.1 * nrm(d), 0.1 * nrm(d)
        wfc1, bfc1 = nrm(d, f) / np.float32(np.sqrt(d)), 0.5 * nrm(f)
        wfc2, bfc2 = nrm(f, d) / np.float32(np.sqrt(f)), 0.1 * nrm(d)
        d_mff = K.drop_args(5, 1, "mff", 0.1) if masked else None
        d_m2 = K.drop_args(5, 1, "m2", 0.1) if masked else None
        masks = None
        if masked:
            masks = (jnp.asarray(K.dropout_mask(d_mff, (nt, f), "cpu").numpy()),
                     jnp.asarray(K.dropout_mask(d_m2, (1, nt, d), "cpu").numpy()))
        w = tuple(jnp.asarray(a) for a in (g2, b2, wfc1, bfc1, wfc2, bfc2))
        _, grads = JV._mlp_residual_bwd(jnp.asarray(x1), jnp.asarray(dy), w, act_bf16=False,
                                        eps=1e-6, activation=act, drop_masks=masks)

        t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
        xf = t(x1[0])
        hf = (xf - xf.mean(-1, keepdim=True)) / torch.sqrt(xf.var(-1, unbiased=False,
                                                                keepdim=True) + 1e-6)
        hf = (hf * t(g2) + t(b2)).float()
        a1 = hf @ torch.tensor(wfc1) + torch.tensor(bfc1)
        do = torch.tensor(dy[0])
        if masked:
            do = do * K.dropout_mask(d_m2, (nt, d), "cpu")
        dhmid = do @ torch.tensor(wfc2).t()
        da1 = K.act_dropout_bwd_plain(dhmid, a1, act, d_mff)
        assert da1.numel() % 2 == 1
        np.testing.assert_allclose(np.asarray(grads["wfc1"]), (hf.t() @ da1).numpy(), atol=1e-5)
        np.testing.assert_allclose(np.asarray(grads["bfc1"]), da1.sum(0).numpy(), atol=1e-5)
        # CPU tensors route the wrapper to the plain version
        assert torch.equal(K.act_dropout_bwd(dhmid, a1, act, d_mff), da1)

    def test_wgrad_row_split(self):
        """The split fills the card and covers every row: both modes' 128 x
        128 tiles (36 at fc1), one block an SM, three whole waves."""
        rows = K.wgrad_rows(135_168, 384, 1536)
        assert 1024 <= rows and -(-135_168 // rows) * 36 >= 132
        rows = K.wgrad_rows(135_168, 384, 1536, round_in=True)
        assert 1024 <= rows and -(-135_168 // rows) * 36 == 3 * 132
        assert K.wgrad_rows(10, 64, 64) == 10

    def test_layerscale_row_split(self):
        """layerscale_bwd's blocks cover every row, no more blocks than
        64-row ranges, four blocks an SM at DINOv2's rows."""
        for M in (1, 63, 999, 17_400, 178_176):
            rows = K.layerscale_rows(M)
            blocks = -(-M // rows)
            assert blocks * rows >= M and (blocks - 1) * rows < M
            assert blocks <= min(4 * 132, -(-M // 64))
        assert -(-178_176 // K.layerscale_rows(178_176)) == 4 * 132


class TestDropoutMask:
    def test_rate_within_five_sigma(self):
        n = 1 << 20
        for rate in (0.1, 0.5):
            m = K.dropout_mask(K.drop_args(11, 2, "m1", rate), (n,), "cpu")
            dropped = float((m == 0).float().mean())
            assert abs(dropped - rate) < 5 * np.sqrt(rate * (1 - rate) / n)
            kept = m[m > 0]
            assert torch.all(kept == torch.tensor(np.float32(1 / (1 - rate))))

    def test_masks_change_with_seed_layer_and_site(self):
        shape = (4096,)
        base = K.dropout_mask(K.drop_args(1, 0, "attn", 0.1), shape, "cpu")
        for args in ((2, 0, "attn"), (1, 1, "attn"), (1, 0, "m1"), (1, 0, "mff"),
                     (1, 0, "m2")):
            other = K.dropout_mask(K.drop_args(*args, 0.1), shape, "cpu")
            assert (other != base).float().mean() > 0.1, args
        again = K.dropout_mask(K.drop_args(1, 0, "attn", 0.1), shape, "cpu")
        assert torch.equal(base, again)

    def test_mask_is_a_prefix_of_a_longer_one(self):
        """Element i depends on i alone, not on the tensor's shape or tiling."""
        d = K.drop_args(4, 3, "m2", 0.1)
        long = K.dropout_mask(d, (64, 100), "cpu").reshape(-1)
        assert torch.equal(K.dropout_mask(d, (32, 100), "cpu").reshape(-1), long[:3200])

    def test_no_dropout_at_rate_zero(self):
        assert K.drop_args(1, 0, "attn", 0.0) is None
        assert K.dropout_mask(None, (3,), "cpu") is None
