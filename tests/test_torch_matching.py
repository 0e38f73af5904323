"""Match extraction in the port against the JAX package on the CPU:
SuperPoint, SuperGlue (per pair and batched), the plain routes of the
SuperGlue kernels and of key-mask / additive-bias attention, the RANSAC
binding, the weight carriers, and extract_match as a whole.

Inputs and weights are drawn from numpy seeds and go through both packages
(weights cross through ``utils/convert.py``); the JAX Pallas kernels run
with ``interpret=True``. Tolerances are stated beside each comparison.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.matching import convert_superglue, convert_superpoint
from posediffusion_tpu.matching import ransac as jransac
from posediffusion_tpu.matching import superglue as jsg
from posediffusion_tpu.matching import superpoint as jsp
from posediffusion_tpu.ops import superglue_kernel as jsgk
from posediffusion_tpu.ops.attention import mha_attention
from posediffusion_tpu_torch.matching import ransac as transac
from posediffusion_tpu_torch.matching import superglue as tsg
from posediffusion_tpu_torch.matching import superpoint as tsp
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops import superglue_kernel as tsgk
from posediffusion_tpu_torch.utils.convert import (
    superglue_state_dict_from_jax,
    superpoint_state_dict_from_jax,
)
from tests.test_matching import (
    K_SYN,
    random_superglue_sd,
    synthetic_planar_two_view,
    synthetic_pure_rotation,
    synthetic_two_view,
)
from test_torch_slice import REPO, _demo_cfg

HW = (48, 64)


def _torch_sd(sd):
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}


def _superpoint_pair(seed=0):
    """A random torch SuperPointNet and the same weights as JAX params."""
    torch.manual_seed(seed)
    net = tsp.SuperPointNet().eval()
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return net, convert_superpoint(sd)


def _superglue(sd):
    model = tsg.SuperGlue().eval()
    model.load_state_dict(_torch_sd(sd), strict=True)
    return model


# ------------------------------------------------------------------ SuperPoint
class TestSuperPoint:
    def test_net_matches_jax(self, rng):
        """Cell logits and descriptor grids within 2e-4 (the JAX package's
        torch-twin tolerance: float32 convolutions summed in another order)."""
        net, params = _superpoint_pair()
        img = rng.uniform(size=(2, 1, 64, 80)).astype(np.float32)
        semi_j, desc_j = jax.jit(jsp.SuperPointNet().apply)(params, img)
        with torch.no_grad():
            semi_t, desc_t = net(torch.tensor(img))
        assert semi_t.shape == (2, 8, 10, 65) and desc_t.shape == (2, 8, 10, 256)
        np.testing.assert_allclose(semi_t.numpy(), np.asarray(semi_j), atol=2e-4)
        np.testing.assert_allclose(desc_t.numpy(), np.asarray(desc_j), atol=2e-4)

    def test_state_dict_round_trip(self):
        net, params = _superpoint_pair(1)
        back = superpoint_state_dict_from_jax(params)
        assert set(back) == set(net.state_dict())
        for k, v in net.state_dict().items():
            assert torch.equal(back[k], v), k

    @pytest.mark.parametrize("levels", [None, 4])
    def test_simple_nms_equal(self, rng, levels):
        """Equal maps, also with plateaus (scores quantised to 4 levels)."""
        s = rng.uniform(size=(2, 32, 40)).astype(np.float32)
        if levels:
            s = np.floor(s * levels).astype(np.float32) / levels
        ref = np.asarray(jsp.simple_nms(jnp.asarray(s), 4))
        out = tsp.simple_nms(torch.tensor(s), 4).numpy()
        np.testing.assert_array_equal(out, ref)

    def test_detect_batched_matches_jax(self):
        """Equal keypoints and validity, scores and descriptors within 1e-5
        (the cell logits' round-off through softmax and bilinear sampling),
        on an input whose top-k scores are apart by more than the two
        frameworks' float32 round-off (checked here). torch's default
        init passes almost no signal through the 8 convs (every NMS maximum
        scores ~1/65, apart by ~1e-9), so these weights are He-normal with
        the cell head scaled by 3."""
        r = np.random.default_rng(3)
        net = tsp.SuperPointNet().eval()
        sd = {}
        for k, v in net.state_dict().items():
            fan_in = int(np.prod(v.shape[1:])) if k.endswith("weight") else 0
            sd[k] = (r.normal(size=v.shape) * np.sqrt(2 / fan_in) if fan_in
                     else np.zeros(v.shape)).astype(np.float32)
        sd["convPb.weight"] *= 3
        net.load_state_dict(_torch_sd(sd), strict=True)
        params = convert_superpoint(sd)
        r = np.random.default_rng(7)
        img = r.uniform(size=(3, 1, 64, 96)).astype(np.float32)
        k = 24
        jk, js, jd, jv = jax.jit(
            lambda p, x: jsp.detect_keypoints_batched(p, x, max_keypoints=k + 1,
                                                      keypoint_threshold=0.0001)
        )(params, img)
        gaps = -np.diff(np.asarray(js), axis=1)
        assert gaps.min() > 1e-5, f"near-tie in the top-k: gap {gaps.min():.2e}"
        tk, ts, td, tv = tsp.detect_keypoints_batched(
            net, torch.tensor(img), max_keypoints=k, keypoint_threshold=0.0001)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk)[:, :k])
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv)[:, :k])
        np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, :k], atol=1e-5)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd)[:, :k], atol=1e-5)

    def test_exact_ties_lower_index_first(self, rng):
        """A score map with exact ties: the lower flat index first, as
        jax.lax.top_k orders them."""
        s = (rng.integers(0, 3, size=(2, 400)) / 2.0).astype(np.float32)
        jv, ji = jax.lax.top_k(jnp.asarray(s), 150)
        tv, ti = tsp.top_k_stable(torch.tensor(s), 150)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    def test_constant_image_ties_match_jax(self):
        """A constant image makes every interior cell score the same in each
        framework: a map of exact ties through NMS and top-k."""
        net, params = _superpoint_pair(3)
        img = np.full((1, 1, 64, 64), 0.5, np.float32)
        jk, _, _, jv = jsp.detect_keypoints_batched(params, jnp.asarray(img), max_keypoints=40)
        tk, _, _, tv = tsp.detect_keypoints_batched(net, torch.tensor(img), max_keypoints=40)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ------------------------------------------------------------------- SuperGlue
@pytest.fixture(scope="module")
def sg_sd():
    return random_superglue_sd(np.random.default_rng(3))


def _sg_inputs(rng, k):
    desc = lambda: rng.normal(size=(1, k, 256)).astype(np.float32) / 16.0
    kpts = lambda: rng.uniform(10, 100, size=(1, k, 2)).astype(np.float32)
    scores = lambda: rng.uniform(size=(1, k)).astype(np.float32)
    return desc(), desc(), kpts(), kpts(), scores(), scores()


_jmatch_pair = jax.jit(jsg.match_pair, static_argnames=(
    "image_hw", "sinkhorn_iterations", "match_threshold", "image_hw1"))


class TestSuperGlue:
    def test_state_dict_loads_strict_and_round_trips(self, sg_sd):
        model = _superglue(sg_sd)
        assert set(model.state_dict()) - set(sg_sd) == {
            k for k in model.state_dict() if k.endswith("num_batches_tracked")}
        back = superglue_state_dict_from_jax(convert_superglue(sg_sd))
        assert set(back) == set(sg_sd)
        for k, v in sg_sd.items():  # the dict holds float64 arrays; weights are float32
            np.testing.assert_array_equal(back[k].numpy(), np.float32(v), err_msg=k)

    @pytest.mark.parametrize("k", [16, 32])
    @pytest.mark.parametrize("partial", [False, True])
    def test_match_pair_matches_jax(self, sg_sd, k, partial):
        """9 layers, threshold 0: equal matches, mscores within 1e-4 (the JAX
        fused-kernel test's bound; 18 float32 layers summed in another order,
        and MagicLeap's interleaved heads here against JAX's permuted ones)."""
        rng = np.random.default_rng(k + partial)
        d0, d1, k0, k1, s0, s1 = _sg_inputs(rng, k)
        m0 = np.ones((1, k), bool)
        m1 = np.ones((1, k), bool)
        if partial:
            m0[0, k - 5:] = False
            m1[0, k // 2:] = False
        ref_m, ref_s = _jmatch_pair(convert_superglue(sg_sd), d0, d1, k0, k1, s0, s1,
                                    m0, m1, (120, 140), sinkhorn_iterations=30,
                                    match_threshold=0.0)
        t = torch.tensor
        out_m, out_s = tsg.match_pair(_superglue(sg_sd), t(d0), t(d1), t(k0), t(k1), t(s0),
                                      t(s1), t(m0), t(m1), (120, 140),
                                      sinkhorn_iterations=30, match_threshold=0.0)
        assert (np.asarray(ref_m) >= 0).sum() > k // 4  # the case has matches
        np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
        np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), atol=1e-4)

    def test_log_sinkhorn_matches_jax(self, rng):
        """Partial masks, 20 iterations: 1e-5 on the valid cells."""
        s = rng.normal(size=(2, 12, 15)).astype(np.float32)
        m0 = np.ones((2, 12), bool)
        m1 = np.ones((2, 15), bool)
        m0[1, 9:] = False
        m1[0, 11:] = False
        ref = np.asarray(jsg.log_sinkhorn(jnp.asarray(s), jnp.asarray(0.7), m0, m1, 20))
        out = tsg.log_sinkhorn(torch.tensor(s), torch.tensor(0.7), torch.tensor(m0),
                               torch.tensor(m1), 20).numpy()
        live = np.concatenate([m0, np.ones((2, 1), bool)], 1)[:, :, None] & \
            np.concatenate([m1, np.ones((2, 1), bool)], 1)[:, None, :]
        np.testing.assert_allclose(out[live], ref[live], atol=1e-5)


# ---------------------------------------------------------- batched matcher
KB = 16


@pytest.fixture(scope="module")
def fused_setup():
    """The JAX package's fused-kernel test setup: Flax-initialised SuperGlue
    params at K 16, and the same weights in the port."""
    rng = np.random.default_rng(0)
    desc = rng.normal(size=(1, KB, 256)).astype(np.float32)
    init = jax.jit(jsg.SuperGlueNet().init, static_argnums=(9,))(
        jax.random.PRNGKey(0), desc, desc, jnp.zeros((1, KB, 2)), jnp.zeros((1, KB, 2)),
        jnp.zeros((1, KB)), jnp.zeros((1, KB)), jnp.ones((1, KB), bool),
        jnp.ones((1, KB), bool), HW)
    params = {"net": jax.tree_util.tree_map(np.asarray, init), "bin_score": np.float32(0.5)}
    model = _superglue(superglue_state_dict_from_jax(params))
    return rng, params, model


def _rand_sets(rng, n):
    kpts = rng.uniform(4, 44, size=(n, KB, 2)).astype(np.float32)
    scores = rng.uniform(size=(n, KB)).astype(np.float32)
    desc = rng.normal(size=(n, KB, 256)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return kpts, scores, desc


_CASES = {
    # pairs, per-frame masks (frames 0..2), threshold: the three cases of
    # tests/test_superglue_kernel.py
    "full": ([(0, 1), (0, 2), (1, 2)], None, 0.2),
    "partial": ([(0, 1)], "partial", 0.0),
    "frame1_partial": ([(0, 1), (0, 2), (1, 2)], "frame1", 0.0),
}


class TestFusedMatchPairs:
    def test_stacks_match_jax(self, fused_setup):
        _, params, model = fused_setup
        j = jsgk.stack_superglue_params(params)
        t = tsgk.stack_superglue_params(model)
        wqkv = np.concatenate([np.asarray(j[n]) for n in ("wq", "wk", "wv")], -1)
        bqkv = np.concatenate([np.asarray(j[n])[:, 0] for n in ("bq", "bk", "bv")], -1)
        np.testing.assert_array_equal(t["wqkv"].numpy(), wqkv)
        np.testing.assert_array_equal(t["bqkv"].numpy(), bqkv)
        for n in ("wm", "w1", "w2"):
            np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]), rtol=1e-6, err_msg=n)
        for n in ("bm", "b1", "b2"):
            np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n])[:, 0], atol=1e-7,
                                       err_msg=n)
        np.testing.assert_array_equal(t["wf"].numpy(), np.asarray(j["wf"]))
        assert t["bin"].item() == 0.5

    @pytest.mark.parametrize("case", sorted(_CASES))
    def test_plain_route_matches_jax(self, fused_setup, case):
        """The port's fused_match_pairs (CPU tensors: every step's plain
        version) against JAX fused_match_pairs(interpret=True) and
        match_pairs_batched_xla: equal matches, mscores within 1e-4, 20
        Sinkhorn iterations; and the encoder within 1e-5."""
        rng, params, model = fused_setup
        pairs, masks, thr = _CASES[case]
        kpts, scores, desc = _rand_sets(np.random.default_rng(len(case)), 3)
        mask = np.ones((3, KB), bool)
        m0 = np.stack([mask[a] for a, _ in pairs])
        m1 = np.stack([mask[b] for _, b in pairs])
        if masks == "partial":
            m0[0, 11:] = False
            m1[0, 7:] = False
        elif masks == "frame1":
            mask[1, 10:] = False
            m0 = np.stack([mask[a] for a, _ in pairs])
            m1 = np.stack([mask[b] for _, b in pairs])
        hw = np.tile(HW, (3, 1)).astype(np.float32)
        xj = np.asarray(jax.jit(jsg.encode_keypoints)(params, desc, kpts, scores, hw))
        xt = tsg.encode_keypoints(model, torch.tensor(desc), torch.tensor(kpts),
                                  torch.tensor(scores), torch.tensor(hw))
        np.testing.assert_allclose(xt.numpy(), xj, atol=1e-5)
        xp = np.stack([np.stack([xj[a], xj[b]]) for a, b in pairs])

        stacks_j = jsgk.stack_superglue_params(params)
        ref_f = jsgk.fused_match_pairs(xp, m0, m1, stacks_j, sinkhorn_iters=20,
                                       match_threshold=thr, interpret=True)
        ref_x = jax.jit(jsg.match_pairs_batched_xla, static_argnames=(
            "sinkhorn_iterations", "match_threshold"))(
            xp, m0, m1, stacks_j, sinkhorn_iterations=20, match_threshold=thr)
        out_m, out_s = tsgk.fused_match_pairs(
            torch.tensor(xp), torch.tensor(m0), torch.tensor(m1),
            tsgk.stack_superglue_params(model), sinkhorn_iters=20, match_threshold=thr)
        assert out_m.dtype == torch.int32 and out_m.shape == (len(pairs), KB)
        for ref_m, ref_s in (ref_f, ref_x):
            np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
            np.testing.assert_allclose(out_s.numpy(), np.asarray(ref_s), atol=1e-4)
        assert (out_m.numpy()[~m0] == -1).all()  # invalid queries never match
        plain_m, _ = tsgk.fused_match_pairs_plain(
            torch.tensor(xp), torch.tensor(m0), torch.tensor(m1),
            tsgk.stack_superglue_params(model), sinkhorn_iters=20, match_threshold=thr)
        assert torch.equal(plain_m, out_m)

    def test_coupling_and_sinkhorn_plain_match_log_sinkhorn(self, rng):
        """superglue_coupling_plain + superglue_sinkhorn_plain == JAX
        log_sinkhorn on m0 m1^T / sqrt(D): 1e-5 on the live cells."""
        C, Kc, D = 2, 12, 32
        m = rng.normal(size=(C, 2, Kc, D)).astype(np.float32)
        m0 = rng.uniform(size=(C, Kc)) < 0.8
        m1 = rng.uniform(size=(C, Kc)) < 0.7
        scores = np.einsum("cnd,cmd->cnm", m[:, 0], m[:, 1]) / D**0.5
        ref = np.asarray(jsg.log_sinkhorn(jnp.asarray(scores), jnp.asarray(0.3), m0, m1, 15))
        cpl, mu, nu, norm = K.superglue_coupling_plain(
            torch.tensor(m), torch.tensor(m0).float(), torch.tensor(m1).float(),
            torch.tensor([0.3]))
        out = K.superglue_sinkhorn_plain(cpl, mu, nu, norm, 15).numpy()
        live = (cpl > K.SG_NEG / 2).numpy()
        np.testing.assert_allclose(out[live], ref[live], atol=1e-5)
        # wrappers on CPU tensors route to the plain versions
        cpl2 = K.superglue_coupling(torch.tensor(m), torch.tensor(m0).float(),
                                    torch.tensor(m1).float(), torch.tensor([0.3]))[0]
        assert torch.equal(cpl2, cpl)

    def test_matches_plain_ties_and_masks(self):
        """Mutual check with the first index on ties, as match_pair: a row
        that ties with an earlier row for a column's maximum does not match
        (the TPU kernel's both-argmax would match both); masked rows and
        columns never match."""
        Z = torch.full((1, 4, 4), -5.0)
        Z[0, 0, 1] = Z[0, 0, 2] = -0.1   # row 0 ties at columns 1 and 2
        Z[0, 1, 0] = -0.2
        Z[0, 2, 1] = -0.1                # row 2 ties row 0 for column 1
        ones = torch.ones(1, 3)
        m, s = K.superglue_matches_plain(Z, ones, ones, 0.0)
        assert m.tolist() == [[1, 0, -1]]
        assert s[0, 0].item() == pytest.approx(np.exp(-0.1))
        m, _ = K.superglue_matches_plain(Z, ones, torch.tensor([[1.0, 0.0, 1.0]]), 0.0)
        assert m.tolist() == [[2, 0, -1]]
        m, _ = K.superglue_matches_plain(Z, torch.tensor([[1.0, 0.0, 1.0]]), ones, 0.0)
        assert m.tolist() == [[1, -1, -1]]
        m, _ = K.superglue_matches_plain(Z, ones, ones, float(np.exp(-0.15)))
        assert m.tolist() == [[1, -1, -1]]  # row 1's exp(-0.2) is under the threshold


# -------------------------------------------------------- attention kernels
class TestAttentionPlain:
    @pytest.mark.parametrize("layout", ["self", "cross"])
    def test_key_mask_matches_pallas_attention(self, rng, layout):
        """kernels.attention_plain with a (B, N) key bias against
        mha_attention(mask=..., impl="interpret") (_pallas_attention): 1e-5,
        at SuperGlue's head split (4 heads of 64) on 2C = 4 sequences; the
        cross layout takes k, v and the mask from the other set of a pair."""
        C, N, H, Dh = 2, 24, 4, 64
        D = H * Dh
        q, k, v = (rng.normal(size=(2 * C, N, D)).astype(np.float32) for _ in range(3))
        mask = rng.uniform(size=(2 * C, N)) < 0.7
        if layout == "cross":
            swap = lambda a: a.reshape(C, 2, *a.shape[1:])[:, ::-1].reshape(a.shape)
            k, v, mask = swap(k), swap(v), swap(mask)
        heads = lambda a: jnp.asarray(a.reshape(2 * C, N, H, Dh).transpose(0, 2, 1, 3))
        ref = mha_attention(heads(q), heads(k), heads(v), mask=jnp.asarray(mask),
                            impl="interpret")
        ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(2 * C, N, D)
        qkv = torch.tensor(np.concatenate([q, k, v], -1))
        key_bias = torch.where(torch.tensor(mask), 0.0, K.SG_NEG)
        out = K.attention_plain(qkv, H, key_bias=key_bias)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
        assert torch.equal(K.attention(qkv, H, key_bias=key_bias), out)

    def test_attn_bias_matches_pallas_attention_bias(self, rng):
        """kernels.attention_plain with an (N, N) additive bias against
        mha_attention(attn_bias=..., impl="interpret")
        (_pallas_attention_bias): 1e-5, a block-diagonal bias as the ViT's
        scale packing builds it."""
        B, N, H, Dh = 3, 40, 6, 64
        D = H * Dh
        q, k, v = (rng.normal(size=(B, N, D)).astype(np.float32) for _ in range(3))
        seg = np.arange(N) * 3 // N
        bias = np.where(seg[:, None] == seg[None], 0.0, K.NEG).astype(np.float32)
        heads = lambda a: jnp.asarray(a.reshape(B, N, H, Dh).transpose(0, 2, 1, 3))
        ref = mha_attention(heads(q), heads(k), heads(v), attn_bias=jnp.asarray(bias),
                            impl="interpret")
        ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(B, N, D)
        qkv = torch.tensor(np.concatenate([q, k, v], -1))
        out = K.attention_plain(qkv, H, attn_bias=torch.tensor(bias))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


# ------------------------------------------------------------------- RANSAC
_SCENES = {
    "general": (lambda r: synthetic_two_view(r), dict(max_error_px=1.0)),
    "calibrated": (lambda r: synthetic_two_view(r),
                   dict(K1=K_SYN, K2=K_SYN, max_error_px=1.0)),
    "planar": (lambda r: synthetic_planar_two_view(r), dict(max_error_px=1.0)),
    "pure_rotation": (lambda r: synthetic_pure_rotation(r), dict(max_error_px=1.0)),
    "planar_outliers": (lambda r: synthetic_planar_two_view(r, n_outliers=60, noise=0.2),
                        dict(max_error_px=2.0, seed=3)),
    "too_few": (lambda r: (r.uniform(0, 320, size=(30, 2)).astype(np.float32),
                           r.uniform(0, 320, size=(30, 2)).astype(np.float32)),
                dict(max_error_px=0.5, min_num_inliers=25, seed=2)),
    "outliers": (lambda r: synthetic_two_view(r, n_outliers=90, noise=0.3),
                 dict(max_error_px=2.0, seed=1)),
}


class TestRansac:
    @pytest.mark.parametrize("scene", sorted(_SCENES))
    def test_verify_two_view_equals_jax(self, scene):
        """The same source and the same seed: identical mask, count, config
        and models."""
        make, kw = _SCENES[scene]
        p1, p2 = make(np.random.default_rng(0))
        ref = jransac.verify_two_view(p1, p2, **kw)
        out = transac.verify_two_view(p1, p2, **kw)
        np.testing.assert_array_equal(out["inlier_mask"], ref["inlier_mask"])
        assert (out["num_inliers"], out["config"], out["config_name"]) == (
            ref["num_inliers"], ref["config"], ref["config_name"])
        for m in ("F", "H", "E"):
            np.testing.assert_array_equal(out[m], ref[m])

    def test_verify_matches_equals_jax(self, rng):
        p1, p2 = synthetic_two_view(rng, n_outliers=150, noise=0.2)
        ref = jransac.verify_matches(p1, p2, threshold_px=2.0, seed=1)
        out = transac.verify_matches(p1, p2, threshold_px=2.0, seed=1)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
        assert out[2] == ref[2] > 100
        assert transac.verify_matches(np.zeros((0, 2)), np.zeros((0, 2)))[2] == 0

    def test_library_builds_outside_the_jax_package(self):
        transac.load_library()
        path = transac.library_path()
        assert path.exists() and path.parent.name == "ransac"
        assert "posediffusion_tpu/" not in str(path.relative_to(REPO))


def test_matching_imports_no_jax():
    code = (
        "import sys\n"
        "import posediffusion_tpu_torch.matching.extract\n"
        "import posediffusion_tpu_torch.ops.superglue_kernel\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax')\n"
        "             or k.startswith('posediffusion_tpu.matching'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -------------------------------------------------------- the slice as a whole
@pytest.fixture(scope="module")
def apple4(tmp_path_factory):
    """The first 4 samples/apple frames at 1/8 size (237 x 133), as the JAX
    package's own end-to-end matching test makes them."""
    from PIL import Image

    folder = tmp_path_factory.mktemp("apple4")
    src = sorted(f for f in os.listdir(os.path.join(REPO, "samples", "apple"))
                 if f.endswith(".jpg"))[:4]
    for name in src:
        im = Image.open(os.path.join(REPO, "samples", "apple", name))
        im.resize((im.width // 8, im.height // 8), Image.BILINEAR).save(folder / name)
    return str(folder)


def _jax_superpoint_params():
    return jax.jit(jsp.SuperPointNet().init)(jax.random.PRNGKey(0), jnp.zeros((1, 1, 64, 64)))


EXTRACT_KW = dict(max_keypoints=64, sinkhorn_iterations=10, match_threshold=0.0,
                  min_pair_matches=8, ransac_threshold_px=1e6)


def test_extract_match_equals_jax_on_apple(apple4):
    """4 downscaled apple frames, random weights, threshold 0 and an
    accept-all RANSAC: the same (kp1, kp2, i12) as the JAX package's
    extract_match(use_fused=False). Keypoints are integer pixels and matches
    argmaxes, so the comparison is exact."""
    from posediffusion_tpu.data.images import load_and_preprocess_images
    from posediffusion_tpu.matching import extract_match as jextract
    from posediffusion_tpu_torch.matching.extract import extract_match

    _, info = load_and_preprocess_images(apple4, 64)
    sp = _jax_superpoint_params()
    sg_sd = random_superglue_sd(np.random.default_rng(1))
    ref = jextract(image_paths=info["paths"], image_info=info,
                   weights=(sp, convert_superglue(sg_sd)), use_fused=False, **EXTRACT_KW)
    net = tsp.SuperPointNet()
    net.load_state_dict(superpoint_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, sp)),
                        strict=True)
    out = extract_match(image_paths=info["paths"], image_info=info,
                        weights=(net, _superglue(sg_sd)), device="cpu", **EXTRACT_KW)
    assert ref[0] is not None and len(ref[0]) >= 8
    assert np.unique(ref[2], axis=0).shape[0] >= 3  # several pairs verified
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_demo_samples_with_extracted_matches(apple4, tmp_path, capsys):
    """demo_torch with GGS on and no matches file: random MagicLeap .pth
    files in GGS.matcher_ckpt_dir, extraction, then GGS sampling at a cut
    depth; the cameras differ from the no-GGS ones."""
    import demo_torch

    wdir = tmp_path / "weights"
    wdir.mkdir()
    sp = jax.tree_util.tree_map(np.asarray, _jax_superpoint_params())
    torch.save(superpoint_state_dict_from_jax(sp), wdir / "superpoint_v1.pth")
    torch.save(_torch_sd(random_superglue_sd(np.random.default_rng(1))),
               wdir / "superglue_outdoor.pth")
    ggs = ("GGS.enable=True", f"GGS.matcher_ckpt_dir={wdir}", "GGS.max_keypoints=64",
           "GGS.match_threshold=0", "GGS.ransac_threshold_px=1e6", "GGS.start_step=2",
           "GGS.iter_num=2", "GGS.sampson_max=1e6", "GGS.min_matches=0")
    out = demo_torch.run(_demo_cfg(tmp_path, f"image_folder={apple4}", *ggs), "cpu")
    printed = capsys.readouterr().out
    assert "Sampling with GGS" in printed and "extracted" in printed
    assert out["R"].shape == (4, 3, 3) and np.isfinite(out["R"]).all()
    plain = demo_torch.run(_demo_cfg(tmp_path, f"image_folder={apple4}", "GGS.enable=False"),
                           "cpu")
    assert np.abs(plain["pose_encoding"] - out["pose_encoding"]).max() > 1e-3
