"""The port's ``fused_vit_trunk`` (its plain route, on the CPU) against the
JAX ``fused_vit_trunk`` Pallas kernel in interpret mode, and the building
blocks against their JAX counterparts.

Shapes are small: depth 2, width 64, 2 heads. The JAX kernel pads N to a
multiple of 8 and B to the chunk; the port pads nothing, so the inputs
(B = 3, N = 14 in two packed segments of 9 and 5) check that the JAX
padding is inert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.ops import vit_kernel as jvk
from posediffusion_tpu.ops.denoiser_kernel import _layer_norm as jax_layer_norm
from posediffusion_tpu_torch.ops import kernels
from posediffusion_tpu_torch.ops.vit_kernel import (
    VIT_KEYS,
    fused_vit_trunk,
    fused_vit_trunk_plain,
    stack_vit_params,
)
from test_torch_models import tiny_vit

N1, N2 = 9, 5


def _inputs(rng):
    jvit, params, vit = tiny_vit(rng)
    x = rng.normal(size=(3, N1 + N2, 64)).astype(np.float32)
    seg = np.concatenate([np.zeros(N1), np.ones(N2)])
    bias = np.where(seg[:, None] == seg[None, :], 0.0, -1e30).astype(np.float32)
    return params["params"], vit, x, bias


def _jax_trunk(net, x, bias, weight_dtype, act_bf16):
    stacks = jvk.stack_vit_params(net, 2, weight_dtype=weight_dtype)
    return np.asarray(jvk.fused_vit_trunk(
        jnp.asarray(x), stacks, nhead=2, chunk=2, act_bf16=act_bf16,
        interpret=True, attn_bias=None if bias is None else jnp.asarray(bias),
    ))


def _port_trunk(vit, x, bias, weight_dtype, act_bf16):
    stacks = stack_vit_params(vit, weight_dtype)
    return fused_vit_trunk(
        torch.tensor(x), stacks, nhead=2, act_bf16=act_bf16,
        attn_bias=None if bias is None else torch.tensor(bias),
    ).numpy()


class TestFusedVitTrunk:
    def test_f32_matches_jax_interpret(self, rng):
        net, vit, x, bias = _inputs(rng)
        out = _port_trunk(vit, x, bias, torch.float32, False)
        ref = _jax_trunk(net, x, bias, jnp.float32, False)
        np.testing.assert_allclose(out, ref, atol=5e-6)

    def test_no_bias_matches_jax_interpret(self, rng):
        # the JAX kernel pads N = 14 to 16 and masks the pad with its own bias
        net, vit, x, _ = _inputs(rng)
        out = _port_trunk(vit, x, None, torch.float32, False)
        ref = _jax_trunk(net, x, None, jnp.float32, False)
        np.testing.assert_allclose(out, ref, atol=5e-6)

    @pytest.mark.parametrize("act_bf16,atol", [(False, 1e-5), (True, 1e-2)])
    def test_bf16_matches_jax_interpret(self, rng, act_bf16, atol):
        """bf16 weights, and with ``act_bf16`` (the main path) bf16-rounded
        operands at the same sites, float32 accumulation. Both packages
        round the same values, so they agree far inside the 5e-2 / 0.15 the
        JAX tests allow the bf16 kernel against the float32 Flax trunk (the
        bf16 trunk is ~2e-2 from the float32 one here). With bf16 weights
        alone the products are exact in float32: 1e-5. With bf16 operands a
        float32 summation-order difference flips a bf16 rounding now and
        then (2^-8 of an O(1) value): up to 3.4e-3 over seeds 0-3, so 1e-2."""
        net, vit, x, bias = _inputs(rng)
        out = _port_trunk(vit, x, bias, torch.bfloat16, act_bf16)
        ref = _jax_trunk(net, x, bias, jnp.bfloat16, act_bf16)
        np.testing.assert_allclose(out, ref, atol=atol)

    def test_stacks_match_jax(self, rng):
        net, vit, _, _ = _inputs(rng)
        ours = stack_vit_params(vit, torch.float32)
        ref = jvk.stack_vit_params(net, 2, weight_dtype=jnp.float32)
        assert set(ours) == set(VIT_KEYS) == set(ref)
        for k in VIT_KEYS:  # JAX keeps vectors as (L, 1, d) for Mosaic
            np.testing.assert_array_equal(
                ours[k].numpy(), np.asarray(ref[k]).reshape(ours[k].shape), err_msg=k
            )

    def test_kernel_route_is_the_plain_version_on_cpu(self, rng):
        _, vit, x, bias = _inputs(rng)
        stacks = stack_vit_params(vit)
        kernels.reset_launch_counts()
        out = fused_vit_trunk(torch.tensor(x), stacks, nhead=2, act_bf16=True,
                              attn_bias=torch.tensor(bias))
        plain = fused_vit_trunk_plain(torch.tensor(x), stacks, nhead=2,
                                      act_bf16=True, attn_bias=torch.tensor(bias))
        np.testing.assert_array_equal(out.numpy(), plain.numpy())
        assert all(n == 0 for n in kernels.launch_counts().values())


class TestBuildingBlocks:
    def test_layernorm_matches_jax(self, rng):
        x = rng.normal(size=(7, 48)).astype(np.float32) * 3 + 1
        g, b = rng.normal(size=(2, 48)).astype(np.float32)
        for eps in (1e-5, 1e-6):
            out = kernels.layernorm(torch.tensor(x), torch.tensor(g), torch.tensor(b), eps)
            ref = jax_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), eps)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)

    def test_gelu_within_the_tpu_erf_bound(self):
        x = np.linspace(-6, 6, 2001).astype(np.float32)
        ours = kernels.linear(torch.tensor(x)[:, None], torch.ones(1, 1),
                              torch.zeros(1), act="gelu")[:, 0].numpy()
        ref = 0.5 * x * (1.0 + np.asarray(jvk._erf(jnp.asarray(x * 2.0**-0.5))))
        # exact erf vs the kernel's A&S erf (|error| <= 1.5e-7), times |x| <= 6
        np.testing.assert_allclose(ours, ref, atol=2e-6)

    def test_attention_bias_kinds(self, rng):
        qkv = torch.tensor(rng.normal(size=(2, 6, 3 * 8)).astype(np.float32))
        mask = torch.tensor([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], dtype=torch.bool)
        key_bias = torch.where(mask, 0.0, kernels.NEG)
        out = kernels.attention(qkv, 2, key_bias=key_bias)
        # a key bias equals the same bias written out as a per-sequence (N, N)
        for bi in range(2):
            dense = key_bias[bi][None, :].expand(6, 6).contiguous()
            ref = kernels.attention(qkv[bi:bi + 1], 2, attn_bias=dense)
            np.testing.assert_allclose(out[bi:bi + 1].numpy(), ref.numpy(), atol=1e-6)
        # masked keys carry no weight: changing their values changes nothing
        qkv2 = qkv.clone()
        qkv2[0, 4:, 8:] = 100.0
        np.testing.assert_allclose(kernels.attention(qkv2, 2, key_bias=key_bias)[0].numpy(),
                                   out[0].numpy(), atol=1e-6)
        assert torch.isfinite(kernels.attention(qkv, 2, key_bias=torch.full((2, 6), kernels.NEG))).all()
