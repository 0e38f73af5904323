"""The launch plan of the GGS cluster kernels (csrc/ggs.cu), on the CPU.

The kernels run only on a card (tests/test_torch_cuda.py); what surrounds
them is Python that runs here:

* the cluster size the wrapper takes (16 where the card schedules it, else
  8, else it raises) and the pairs each block owns;
* the shared-memory formula, the Python mirror held against the expression
  in ``csrc/ggs.cu`` and at 6, 20 and 50 frames with 100 and 1,024 matches
  a pair, with whether the table slice stays in shared memory;
* every (padded) pair owned by exactly one block of the cluster;
* each frame's gather, block by block through the owner and offset the
  kernel computes, in ``fent`` order, against the plain version's sums;
* the route between the one-block and the cluster kernel
  (``diffusion/ggs.py`` ``RESIDENT_MAX_ELEMENTS``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from posediffusion_tpu_torch.diffusion import ggs as G
from posediffusion_tpu_torch.ops import ggs_kernel as GK
from posediffusion_tpu_torch.ops import kernels as K
from posediffusion_tpu_torch.ops.ggs_grad import (
    ggs_tables,
    pack_matches_grouped,
    pad_grouped_pairs,
)

GGS_CU = Path(K.__file__).resolve().parents[1] / "csrc" / "ggs.cu"


def grouped(n, per_pair, seed=0):
    """Random matches, ``per_pair`` for every pair of n frames."""
    r = np.random.default_rng(seed)
    a, b = np.triu_indices(n, k=1)
    i12 = np.repeat(np.stack([a, b], 1), per_pair, axis=0)
    kp = r.uniform(0, 224, size=(2, len(i12), 2)).astype(np.float32)
    return pack_matches_grouped(kp[0], kp[1], i12, n)


def plan(n, per_pair, cluster):
    """(pairs a block, padded pairs, blocks) of n frames over ``cluster``."""
    P = n * (n - 1) // 2
    pb = -(-P // cluster)
    padded = -(-P // pb) * pb
    return pb, padded, padded // pb


class _Lib:
    """A stand-in for the kernels' library: ``fits`` says which cluster
    sizes the card would schedule."""

    def __init__(self, fits):
        self.fits, self.asked = fits, []

    def pd_ggs_max_active_clusters(self, N, pb, Q, c):
        self.asked.append((N, pb, Q, c))
        return 2 if c in self.fits else 0


@pytest.mark.parametrize("fits,expected", [((16, 8), 16), ((8,), 8), ((), None)])
def test_cluster_choice(monkeypatch, fits, expected):
    lib = _Lib(fits)
    monkeypatch.setattr(K, "load_library", lambda: lib)
    K.ggs_cluster_size.cache_clear()
    try:
        if expected is None:
            with pytest.raises(RuntimeError, match="can be scheduled"):
                K.ggs_cluster_size(20, 190, 128)
        else:
            assert K.ggs_cluster_size(20, 190, 128) == expected
        # 16 is asked first, with 12 pairs a block; 8 with 24
        assert lib.asked[0] == (20, 12, 128, 16)
        assert [a[3] for a in lib.asked] == [16, 8][:len(lib.asked)]
        if len(lib.asked) > 1:
            assert lib.asked[1] == (20, 24, 128, 8)
    finally:
        K.ggs_cluster_size.cache_clear()


@pytest.mark.parametrize("n,per_pair,pb,blocks", [
    (6, 100, 1, 15), (20, 100, 12, 16), (20, 1024, 12, 16), (50, 100, 77, 16)])
def test_pairs_per_block_off_the_card(n, per_pair, pb, blocks):
    """Off the card the plan takes a cluster of 16: 190 pairs of 20 frames
    are 12 a block (192 padded), a warp each; 77 a block at 50 frames loop
    over 12 warps."""
    gm = grouped(n, per_pair)
    chunk = GK.default_chunk_pairs(gm)
    assert chunk == pb == plan(n, per_pair, 16)[0]
    P = pad_grouped_pairs(gm, chunk).valid.shape[0]
    assert P % chunk == 0 and P // chunk == blocks <= K.GGS_CLUSTERS[0]
    assert K.ggs_warps(chunk) == min(chunk, K.GGS_MAX_WARPS) == min(pb, 12)


def _cu_base_floats():
    """csrc/ggs.cu's ggs_base_floats as a Python function of (N, Pb, P)."""
    src = GGS_CU.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    body = re.search(r"ggs_base_floats\(int N, int Pb, int P\) \{\s*const size_t n = (.*?);",
                     src, re.S).group(1)
    expr = re.sub(r"\(size_t\)", "", body)
    for k, v in consts.items():
        expr = re.sub(rf"\b{k}\b", str(v), expr)
    assert re.search(r"return \(n \+ 3\) & ~\(size_t\)3;", src)
    return lambda N, Pb, P: (eval(f"({expr})", {}, dict(N=N, Pb=Pb, P=P)) + 3) // 4 * 4


@pytest.mark.parametrize("n", [6, 20, 50])
@pytest.mark.parametrize("per_pair", [100, 1024])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_shared_memory_formula_mirrors_the_kernel(n, per_pair, cluster):
    base = _cu_base_floats()
    Q = 128 if per_pair == 100 else 1024  # pack_matches_grouped's padding
    pb, P, _ = plan(n, per_pair, cluster)
    assert K._ggs_base_floats(n, pb, P) == base(n, pb, P)
    table = 5 * pb * Q
    resident = 4 * (base(n, pb, P) + table) <= 232448
    assert K.ggs_table_resident(n, pb, P, Q) == resident
    assert K.ggs_smem_bytes(n, pb, P, Q) == 4 * (base(n, pb, P) + (table if resident else 0))


# (frames, matches a pair) -> is the table slice resident in a cluster of 16
RESIDENT_AT_16 = {(6, 100): True, (6, 1024): True, (20, 100): True, (20, 1024): False,
                  (50, 100): False, (50, 1024): False}


@pytest.mark.parametrize("n,per_pair", sorted(RESIDENT_AT_16))
def test_where_the_table_lives(n, per_pair):
    """20 frames at 100/pair: 30,720 B of table a block beside 27,280 B;
    at 1,024/pair the 245,760 B slice stays in global memory; at 50 frames
    every block holds all 1,232 pairs' rows (142,912 B), and the 197,120 B
    slice of 100/pair no longer fits beside them."""
    Q = 128 if per_pair == 100 else 1024
    pb, P, _ = plan(n, per_pair, 16)
    assert K.ggs_table_resident(n, pb, P, Q) == RESIDENT_AT_16[(n, per_pair)]
    assert K.ggs_smem_bytes(n, pb, P, Q) <= 232448
    if (n, per_pair) == (20, 100):
        assert K.ggs_smem_bytes(n, pb, P, Q) == 27280 + 30720


@pytest.mark.parametrize("n", [2, 3, 6, 17, 20, 50])
@pytest.mark.parametrize("cluster", [8, 16])
def test_every_pair_has_one_owner(n, cluster):
    """Block r owns pairs [r Pb, (r + 1) Pb): each padded pair once, at most
    ``cluster`` blocks, the real pairs first."""
    P = n * (n - 1) // 2
    pb, padded, blocks = plan(n, 100, cluster)
    assert blocks <= cluster and padded >= P
    owners = [p // pb for p in range(padded)]
    owned = [p for r in range(blocks) for p in range(r * pb, (r + 1) * pb)]
    assert sorted(owned) == list(range(padded))
    assert max(owners) == blocks - 1


@pytest.mark.parametrize("n,cluster", [(6, 16), (20, 16), (20, 8), (9, 16)])
def test_gather_follows_fent(n, cluster):
    """The kernel's gather of frame n: its entries in fent order, each
    naming pair p (written by block p // Pb, its row p % Pb there) and role
    r, whose 12 values sit at p's row offsets 9 r + k and 18 + 3 r + k.
    Summed so, the rows give the plain version's per-frame sums B1^T dR1 +
    B2^T dR2, and the padded pairs come last in frames 0 and 1."""
    gm = grouped(n, 8)
    pb = -(-gm.valid.shape[0] // cluster)
    t = ggs_tables(pad_grouped_pairs(gm, pb))
    P = t.valid.shape[0]
    fptr, fent = t.fptr.numpy(), t.fent.numpy()
    rows = np.random.default_rng(1).normal(size=(P, 29)).astype(np.float32)
    rows[gm.valid.shape[0]:] = 0.0  # padded pairs: no valid match, zero rows
    blocks = [rows[r * pb:(r + 1) * pb] for r in range(P // pb)]
    pi1, pi2 = t.pi1.numpy(), t.pi2.numpy()
    for f in range(n):
        ents = fent[fptr[f]:fptr[f + 1]]
        roles, pairs = ents & 1, ents >> 1
        # role then pair, ascending: the order the kernel sums in
        assert list(zip(roles, pairs)) == sorted(zip(roles, pairs))
        assert all((pi1 if r == 0 else pi2)[p] == f for r, p in zip(roles, pairs))
        acc = np.zeros(12, np.float32)
        for r, p in zip(roles, pairs):
            o = blocks[p // pb][p % pb]
            acc += np.concatenate([o[9 * r:9 * r + 9], o[18 + 3 * r:21 + 3 * r]])
        B1, B2 = t.B1.numpy(), t.B2.numpy()
        ref = np.concatenate([B1[:, f] @ rows[:, :9] + B2[:, f] @ rows[:, 9:18],
                              B1[:, f] @ rows[:, 18:21] + B2[:, f] @ rows[:, 21:24]])
        np.testing.assert_allclose(acc, ref, rtol=1e-5, atol=1e-5)
        real = pairs < gm.valid.shape[0]
        assert not np.any(np.diff(real.astype(int)) > 0)  # padded ones last in a role


@pytest.mark.parametrize("n,per_pair,resident", [
    (3, 100, True), (5, 100, True), (6, 100, True), (8, 100, False), (6, 1024, False),
    (20, 100, False), (20, 1024, False)])
def test_route_between_the_kernels(n, per_pair, resident):
    """diffusion/ggs.py takes the one-block kernel up to
    RESIDENT_MAX_ELEMENTS = 2,048 table entries (6 frames at 128 padded
    matches, where the two kernels tie), the cluster kernel above; plan_ggs
    pads the cluster's pairs to whole blocks."""
    gm = grouped(n, per_pair)
    assert G.RESIDENT_MAX_ELEMENTS == 2048
    assert G.fused_fits(gm) == resident
    p = G.plan_ggs(gm)
    assert p.resident == resident
    if not resident:
        assert p.chunk == GK.default_chunk_pairs(gm)
        assert p.tables.valid.shape[0] % p.chunk == 0
        assert p.tables.valid.shape[0] // p.chunk <= K.GGS_CLUSTERS[0]
