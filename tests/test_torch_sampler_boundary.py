"""The sampler's step boundary: ``kernels.sampler_boundary`` (the epilogue of
step r and the prologue of step r + 1 in one launch of
``csrc/sampler.cu``'s cluster kernel) and the host loop that launches it,
on the CPU, where every wrapper takes its plain version.

- the boundary equals the epilogue then the prologue, bitwise (the plain
  version is those two calls), at 1, 20, 33 and 64 rows;
- ``run_sampler`` makes 1 prologue, R - 1 boundaries and 1 epilogue call
  and gives bitwise the state of the loop before the boundary existed
  (prologue, layers, epilogue at every step), written out here;
- at a small denoiser (2 layers, d_model 64, 6 frames, 5 steps) the loop
  holds against the JAX package's ``fused_sample_loop`` in interpret mode
  with the noise the JAX kernel draws replayed into the port, to the
  tolerance of ``tests/test_torch_sampler_kernel.py`` (5e-4 absolute,
  1e-4 relative: the JAX kernel's bf16 stacks and its own summation order);
- ``kernels.sampler_smem_bytes`` is the shared-memory expression of
  ``csrc/sampler.cu`` (SAMPLER_REGIONS), parsed from the source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu.diffusion.schedule import make_schedule as jmake_schedule
from posediffusion_tpu.ops.sampler_kernel import fused_sample_loop as jax_fused_sample_loop
from posediffusion_tpu_torch.diffusion.schedule import make_schedule
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops.denoiser_kernel import encoder_layer_math
from posediffusion_tpu_torch.ops.sampler_kernel import prepare_sampler, run_sampler
from test_torch_models import tiny_denoiser

SAMPLER_CU = Path(K.__file__).resolve().parents[1] / "csrc" / "sampler.cu"


def _inputs(rows, D=64, HID=128, TD=9, NH=10, R=4, seed=0):
    r = np.random.default_rng(seed + rows)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    head = [t(r.normal(size=s) * c) for s, c in (
        ((D, HID), 0.05), ((HID,), 0.1), ((HID,), 1.0), ((HID,), 0.1),
        ((HID, TD), 0.1), ((TD,), 0.1))]
    prologue = [t(r.normal(size=(TD * NH, D)) * 0.05), t(r.normal(size=(TD * NH, D)) * 0.05),
                t(r.normal(size=(TD, D)) * 0.05), t(r.normal(size=(rows, D))),
                t(r.normal(size=(R, D)))]
    return dict(h=t(r.normal(size=(rows, D))), head=head, prologue=prologue,
                coef=t(r.uniform(0.5, 1.5, size=(R, 2))),
                noise=t(r.normal(size=(R, rows, TD)) * 0.1), x=t(r.normal(size=(rows, TD))))


@pytest.mark.parametrize("boundary", [K.sampler_boundary, K.PLAIN.sampler_boundary],
                         ids=["wrapper", "plain"])
@pytest.mark.parametrize("rows", [1, 20, 33, 64])
@pytest.mark.parametrize("step", [0, 2])
def test_boundary_is_epilogue_then_prologue(boundary, rows, step):
    s = _inputs(rows)
    x_b, x_ref = s["x"].clone(), s["x"].clone()
    h_b = boundary(s["h"], *s["head"], s["coef"], s["noise"], x_b, step, *s["prologue"], 1e-5)
    K.sampler_epilogue_plain(s["h"], *s["head"], s["coef"], s["noise"], x_ref, step, 1e-5)
    h_ref = K.sampler_prologue_plain(x_ref, *s["prologue"], step + 1)
    assert h_b.shape == (rows, 64)
    assert torch.equal(x_b, x_ref) and torch.equal(h_b, h_ref)
    assert not torch.equal(x_b, s["x"])  # the state moved in place


@pytest.mark.parametrize("step", [-1, 3, 4])
def test_boundary_refuses_a_last_step(step):
    """Step R - 1 has no next step: the boundary raises and leaves x as it was."""
    s = _inputs(5)
    x = s["x"].clone()
    with pytest.raises(ValueError, match="no step"):
        K.sampler_boundary(s["h"], *s["head"], s["coef"], s["noise"], x, step,
                           *s["prologue"])
    assert torch.equal(x, s["x"])


class Counting:
    """An ``ops`` namespace over ``kernels.PLAIN`` that counts each wrapper's calls."""

    def __init__(self):
        self.counts = {}

    def __getattr__(self, name):
        fn = getattr(K.PLAIN, name)

        def call(*args, **kwargs):
            self.counts[name] = self.counts.get(name, 0) + 1
            return fn(*args, **kwargs)

        return call


def _previous_loop(inp):
    """The host loop as it was before the step boundary: per step the
    prologue, the trunk layers, the epilogue."""
    B, N, TD = inp.shape
    x = inp.x0.clone()
    with torch.no_grad():
        for r in range(inp.steps):
            h = K.sampler_prologue_plain(x, *inp.prologue, r)
            for w in inp.layers:
                h = encoder_layer_math(h, *w, nhead=inp.nhead, seq_len=N, eps=1e-5,
                                       act="relu", key_bias=inp.key_bias, ops=K.PLAIN)
            K.sampler_epilogue_plain(h, *inp.head, inp.coef, inp.noise, x, r, inp.head_eps)
    return x.view(B, N, TD)


@pytest.mark.parametrize("steps", [1, 2, 5])
def test_run_sampler_launches_one_boundary_a_step(rng, steps):
    _, _, den = tiny_denoiser(rng, N=6)
    z = torch.tensor(rng.normal(size=(1, 6, 16)).astype(np.float32))
    inp = prepare_sampler(den, make_schedule(timesteps=steps), z, weight_dtype=torch.float32,
                          generator=torch.Generator().manual_seed(steps))
    ops = Counting()
    out = run_sampler(inp, ops)
    assert {k: ops.counts.get(k, 0) for k in
            ("sampler_prologue", "sampler_boundary", "sampler_epilogue")} == {
        "sampler_prologue": 1, "sampler_boundary": steps - 1, "sampler_epilogue": 1}
    assert torch.equal(out, _previous_loop(inp))


def test_run_sampler_without_steps_returns_x0(rng):
    _, _, den = tiny_denoiser(rng, N=6)
    z = torch.tensor(rng.normal(size=(1, 6, 16)).astype(np.float32))
    inp = prepare_sampler(den, make_schedule(timesteps=3), z, n_cond=3,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(run_sampler(inp, K.PLAIN), inp.x0.view(1, 6, 9))


def test_boundary_loop_matches_jax_interpret(rng):
    N, T = 6, 5
    params, den = tiny_denoiser(rng, N=N)[1:]
    z = rng.normal(size=(1, N, 16)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref, _ = jax_fused_sample_loop(params, jmake_schedule(timesteps=T), jnp.asarray(z), key,
                                   nhead=2, num_encoder_layers=2, weight_dtype=jnp.float32,
                                   rng_chain=True, interpret=True)
    # the JAX kernel's draws (rng_chain=True), replayed: x0, then one per step
    key, init_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(init_key, (N, 9)))
    noises = []
    for _ in range(T):
        key, nk = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(nk, (N, 9))))
    inp = prepare_sampler(den, make_schedule(timesteps=T), torch.tensor(z),
                          weight_dtype=torch.float32, x0=torch.tensor(x0)[None],
                          noises=torch.tensor(np.stack(noises))[:, None])
    ops = Counting()
    out = run_sampler(inp, ops)
    assert ops.counts["sampler_boundary"] == T - 1
    np.testing.assert_allclose(out.numpy()[0], np.asarray(ref)[0], atol=5e-4, rtol=1e-4)


def _cu_smem_bytes():
    """csrc/sampler.cu's shared-memory bytes as a Python function of
    (cluster, D, HID, TD, NH): its SAMPLER_REGIONS list, each region rounded
    up to 32 floats, as sampler_smem_bytes sums them."""
    src = SAMPLER_CU.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (SR|KPP|W1P) = (\d+);", src)}
    body = re.search(r"#define SAMPLER_REGIONS\(KS, HID, TD, HH, PW\)\s*\\\s*\{(.*?)\}\n",
                     src, re.S).group(1)
    regions, depth, cur = [], 0, ""
    for ch in body.replace("\\", " "):  # split on the top-level commas
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            regions.append(cur.strip())
            cur = ""
        else:
            cur += ch
    regions.append(cur.strip())
    assert len(regions) == int(re.search(r"constexpr int kRegions = (\d+);", src).group(1))
    assert re.search(r"const int KS = D / SC, HH = td \* NH, PW = 2 \* HH \+ td;", src)
    assert re.search(r"for \(int i = 0; i < kRegions; \+\+i\) floats \+= r32\(n\[i\]\);", src)
    assert re.search(r"constexpr int r32\(int n\) \{ return \(n \+ 31\) & ~31; \}", src)

    def smem(SC, D, HID, TD, NH):
        env = dict(consts, SC=SC, KS=D // SC, HID=HID, TD=TD, HH=TD * NH, PW=2 * TD * NH + TD,
                   imax=max)
        return 4 * sum((eval(e, {}, env) + 31) // 32 * 32 for e in regions)

    return consts, smem


@pytest.mark.parametrize("cluster", K.SAMPLER_CLUSTERS)
@pytest.mark.parametrize("D,HID,TD,NH", [(512, 128, 9, 10), (512, 0, 9, 10), (512, 128, 9, 0),
                                         (256, 64, 7, 6), (384, 128, 9, 10)])
def test_shared_memory_formula_mirrors_the_kernel(cluster, D, HID, TD, NH):
    consts, smem = _cu_smem_bytes()
    assert consts == {"SR": K.SAMPLER_TILE_ROWS, "KPP": K.SAMPLER_SPLIT, "W1P": 12}
    assert K.sampler_smem_bytes(cluster, D, HID, TD, NH) == smem(cluster, D, HID, TD, NH)
    assert K.sampler_smem_bytes(cluster, D, HID, TD, NH) <= 232448
    if (D, HID, TD, NH) == (512, 128, 9, 10):
        assert K.sampler_smem_bytes(cluster, D, HID, TD, NH) == {8: 199808, 16: 126336}[cluster]
