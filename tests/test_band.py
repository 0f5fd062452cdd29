"""Banded fill entry point (ops/band.fill_banded) and its certificate.

On the CPU test backend fill_banded runs the lax twin; these tests pin its
contract against the full-matrix DP, the executable spec and the
traceback.  The CUDA kernel's wrapper (shapes, platform dispatch) is
checked here without a card; its bit-parity with the twin runs on the card
(``gpu`` tests below, and phase 2 of chip_smoke.py).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bioinfo1_tpu.ops import align as al
from bioinfo1_tpu.ops import band


def _pack(seqs, pad):
    arr = np.zeros((len(seqs), pad), dtype=np.uint8)
    lens = np.zeros(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        arr[i, :len(s)] = np.frombuffer(s.encode("latin1"), dtype=np.uint8)
        lens[i] = len(s)
    return arr, lens


def _rand_pairs(seed, count, maxlen=90):
    rng = random.Random(seed)
    pairs = []
    for _ in range(count):
        q = "".join(rng.choice("ACGT") for _ in range(rng.randrange(1, maxlen)))
        t = "".join(rng.choice("ACGT") for _ in range(rng.randrange(1, maxlen)))
        pairs.append((q, t))
    base = "".join(rng.choice("ACGT") for _ in range(60))
    mut = "".join(c if rng.random() > 0.1 else rng.choice("ACGT") for c in base)
    pairs.append((base, mut))
    pairs.append(("AC-GT", "ACGT"))          # dash cost-0 path
    return pairs


def _ont_like_pairs(seed, count, minlen=150, maxlen=300, err=0.02):
    """Near-diagonal pairs: substitutions + sparse indels, like chained ONT
    regions - the case the band is built for."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(count):
        n = rng.randrange(minlen, maxlen)
        base = "".join(rng.choice("ACGT") for _ in range(n))
        mut = list(base)
        for _ in range(int(n * err)):
            p = rng.randrange(len(mut))
            op = rng.random()
            if op < 0.6:
                mut[p] = rng.choice("ACGT")
            elif op < 0.8:
                mut.insert(p, rng.choice("ACGT"))
            else:
                del mut[p]
        pairs.append((base, "".join(mut)))
    return pairs


def _certify(out, qa, ql, ta, tl, params, W, **kw):
    m, mm, g = params
    return np.asarray(band.certify(out.score, qa, ql, ta, tl, jnp.int32(m),
                                   jnp.int32(mm), jnp.int32(g), W, **kw))


# --- whole-matrix band == full DP ------------------------------------------

@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("params", [(1, -1, -1), (2, -1, -2), (2, -1, 2)])
def test_fill_whole_band_matches_full(mode, params):
    """A band covering the whole matrix is the full DP for every scoring,
    gap sign included: scores and goal cells equal align_batch's."""
    match, mismatch, gap = params
    pairs = _rand_pairs(7 * mode + match, 10)
    qa, ql = _pack([p[0] for p in pairs], max(len(p[0]) for p in pairs))
    ta, tl = _pack([p[1] for p in pairs], max(len(p[1]) for p in pairs))
    want = al.align_batch(qa, ql, ta, tl, mode, match, mismatch, gap)
    got = band.fill_banded(qa, ql, ta, tl, match, mismatch, gap,
                           band=128, mode=mode)
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(jax.device_get(getattr(got, f)),
                                      jax.device_get(getattr(want, f)), f)


def test_fill_batch_padding_isolation():
    """Rows of very different lengths in one padded batch do not leak into
    each other."""
    pairs = [("A", "A"), ("ACGTACGTACGT", "ACGT"),
             ("AC", "ACGTACGTACGTACGTAAAA"), ("GGGG", "CCCC")] * 3
    qa, ql = _pack([p[0] for p in pairs], 16)
    ta, tl = _pack([p[1] for p in pairs], 32)
    for mode in (0, 1, 2):
        want = al.align_batch(qa, ql, ta, tl, mode, 1, -1, -1)
        got = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=64,
                               mode=mode)
        np.testing.assert_array_equal(jax.device_get(got.score),
                                      jax.device_get(want.score))


# --- certificate -------------------------------------------------------------

@pytest.mark.parametrize("params", [(1, -1, -1), (2, -1, -2)])
def test_certified_scores_exact(params):
    match, mismatch, gap = params
    pairs = _ont_like_pairs(11 + match, 8)
    pairs += [("A", "A"), ("AC-GT", "ACGT"), ("ACGT" * 8, "ACGT" * 8)]
    qa, ql = _pack([p[0] for p in pairs], max(len(p[0]) for p in pairs))
    ta, tl = _pack([p[1] for p in pairs], max(len(p[1]) for p in pairs))
    want = al.align_batch(qa, ql, ta, tl, 0, match, mismatch, gap)
    got = band.fill_banded(qa, ql, ta, tl, match, mismatch, gap, band=128)
    cert = _certify(got, qa, ql, ta, tl, params, 128)
    # ONT-like pairs at 2% error are comfortably certifiable at band 128.
    assert cert.all()
    np.testing.assert_array_equal(np.asarray(got.score)[cert],
                                  np.asarray(want.score)[cert])


def test_certificate_rejects_out_of_band():
    # 300-base deletion in the middle: optimal path leaves a 128-band.
    rng = random.Random(3)
    base = "".join(rng.choice("ACGT") for _ in range(700))
    mut = base[:200] + base[500:]
    qa, ql = _pack([base], 700)
    ta, tl = _pack([mut], 700)
    got = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=128)
    cert = _certify(got, qa, ql, ta, tl, (1, -1, -1), 128)
    want = al.align_batch(qa, ql, ta, tl, 0, 1, -1, -1)
    if cert[0]:
        np.testing.assert_array_equal(np.asarray(got.score),
                                      np.asarray(want.score))
    else:
        assert np.asarray(got.score)[0] <= np.asarray(want.score)[0]


def test_dash_blocks_certificate():
    # '-' makes gaps free (team_alignment.cpp:25-28): the score bound is
    # invalid, so certify() must refuse (except whole-matrix coverage).
    q = "ACGT" + "-" * 200 + "ACGT" * 40
    t = "ACGT" * 41
    qa, ql = _pack([q], len(q))
    ta, tl = _pack([t], 256)
    got = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=128)
    cert = _certify(got, qa, ql, ta, tl, (1, -1, -1), 128)
    whole = (ql[0] <= 128) & (tl[0] <= 126)
    assert whole or not cert[0]


def test_banded_local_certificate_rejects_far_repeat():
    """A local pair whose best alignment lies far off-diagonal (long target
    prefix before the match) must NOT be certified at a narrow band."""
    rng = random.Random(9)
    core = "".join(rng.choice("ACGT") for _ in range(150))
    q = core
    t = "".join(rng.choice("ACGT") for _ in range(400)) + core
    qa, ql = _pack([q], len(q))
    ta, tl = _pack([t], len(t))
    got = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=64, mode=1,
                           want_parents=True)
    cert = _certify(got, qa, ql, ta, tl, (1, -1, -1), 64, strict=True,
                    mode=1)
    full = al.align_batch(qa, ql, ta, tl, 1, 1, -1, -1)
    assert int(full.score[0]) == 150
    assert int(got.score[0]) < 150
    assert not cert[0]


# --- map_step integration ----------------------------------------------------

def test_map_step_banded_exact_with_fallback():
    """Fused step with band on == band off on every certified read; the
    reads that leave the band are flagged inexact, never wrong silently."""
    from bioinfo1_tpu.index import builder
    from bioinfo1_tpu.pipeline import device_map as dm

    rng = np.random.default_rng(5)
    k, w = 15, 5
    genome = "".join("CATG"[i] for i in rng.integers(0, 4, 8192))
    index = builder.build_index(genome, k, w, 0.001)
    didx = dm.device_index_from_host(index)

    L = 512
    gbytes = np.frombuffer(genome.encode(), dtype=np.uint8)
    reads = np.zeros((8, L), dtype=np.uint8)
    lens = np.full((8,), L, dtype=np.int32)
    for b in range(8):
        start = int(rng.integers(0, len(genome) - L))
        r = gbytes[start:start + L].copy()
        if b >= 6:
            # Large internal deletion: region needs the full DP.
            r = np.concatenate([r[:100], r[400:], gbytes[:300]])[:L]
        reads[b] = r
    args = (jnp.asarray(reads), jnp.asarray(lens), didx,
            jnp.int32(1), jnp.int32(-1), jnp.int32(-1))
    kw = dict(k=k, w=w, mode=0, budget=512, region_cap=2 * L)
    out_full = jax.device_get(dm.map_step(*args, **kw, band=0))
    out_band = jax.device_get(dm.map_step(*args, **kw, band=128))
    np.testing.assert_array_equal(out_full.mapped, out_band.mapped)
    np.testing.assert_array_equal(out_full.t_begin, out_band.t_begin)
    exact = ~out_band.inexact
    np.testing.assert_array_equal(out_full.score[exact],
                                  out_band.score[exact])
    assert (out_band.score[~exact] <= out_full.score[~exact]).all()


# --- parents and traceback ---------------------------------------------------

def test_banded_parents_cigar_exact():
    """Banded parents + strict certificate -> byte-identical CIGARs."""
    from bioinfo1_tpu.utils import cigar as cg

    pairs = _ont_like_pairs(21, 10, minlen=400, maxlen=700)
    qs = [p[0] for p in pairs]
    ts = [p[1] for p in pairs]
    qa, ql = _pack(qs, max(len(s) for s in qs))
    ta, tl = _pack(ts, max(len(s) for s in ts))
    W = 128
    full = al.align_batch(qa, ql, ta, tl, 0, 1, -1, -1, want_parents=True)
    got = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=W,
                           want_parents=True)
    cert = _certify(got, qa, ql, ta, tl, (1, -1, -1), W, strict=True)
    assert cert.all()
    np.testing.assert_array_equal(np.asarray(got.score),
                                  np.asarray(full.score))
    fp = np.asarray(full.parents)
    bp = np.asarray(got.parents)
    for b in range(len(pairs)):
        want_cig, _ = cg.traceback(fp[:, b, :], qs[b], ts[b],
                                   len(qs[b]), len(ts[b]), "global",
                                   int(full.score[b]), 1, -1, -1)
        got_cig, _ = cg.traceback(bp[:, b, :], qs[b], ts[b],
                                  len(qs[b]), len(ts[b]), "global",
                                  int(got.score[b]), 1, -1, -1, band=W)
        assert want_cig == got_cig, (b, want_cig, got_cig)


@pytest.mark.parametrize("mode,name", [(1, "local"), (2, "semiGlobal")])
def test_banded_local_semiglobal_exact(mode, name):
    """Banded local/semiGlobal: certified scores, goal cells and CIGARs equal
    the full DP / executable spec byte-for-byte."""
    from bioinfo1_tpu import reference_model as rm
    from bioinfo1_tpu.utils import cigar as cg

    pairs = _ont_like_pairs(41 + mode, 8, minlen=200, maxlen=400, err=0.05)
    qs = [p[0] for p in pairs]
    ts = [p[1] for p in pairs]
    qa, ql = _pack(qs, max(len(s) for s in qs))
    ta, tl = _pack(ts, max(len(s) for s in ts))
    W = 128
    full = al.align_batch(qa, ql, ta, tl, mode, 1, -1, -1)
    got = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=W, mode=mode,
                           want_parents=True)
    cert = _certify(got, qa, ql, ta, tl, (1, -1, -1), W, strict=True,
                    mode=mode)
    assert cert.all(), cert
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(full, f)), f)
    gp = np.asarray(got.parents)
    for b in range(len(pairs)):
        want = rm.align(qs[b], ts[b], name, 1, -1, -1, want_cigar=True)
        got_cig, tb = cg.traceback(gp[:, b, :], qs[b], ts[b],
                                   int(got.goal_i[b]), int(got.goal_j[b]),
                                   name, int(got.score[b]), 1, -1, -1,
                                   band=W)
        assert got.score[b] == want.score, b
        assert got_cig == want.cigar, (b, got_cig, want.cigar)
        if name == "local":
            assert tb == want.target_begin, b


def test_score_only_fill_matches_parents_fill():
    """want_parents=False (no parent stream) gives the same scores and goal
    cells as the parents fill, and a (0, 0, 0) placeholder."""
    pairs = _ont_like_pairs(33, 6, minlen=200, maxlen=400)
    qa, ql = _pack([p[0] for p in pairs], max(len(p[0]) for p in pairs))
    ta, tl = _pack([p[1] for p in pairs], max(len(p[1]) for p in pairs))
    for mode in (0, 1, 2):
        a = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=128, mode=mode,
                             want_parents=True)
        b = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=128, mode=mode)
        assert b.parents.shape == (0, 0, 0)
        assert a.parents.shape[1:] == (len(pairs), 128 // 16)
        for f in ("score", "goal_i", "goal_j"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)), f)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_dash_free_fill_equals_full_dp(mode):
    """dash_free=True (the kernel's static specialization; the twin needs no
    such flag) on dash-free inputs gives the full DP's scores and goals."""
    pairs = _ont_like_pairs(99, 8)
    qa, ql = _pack([p[0] for p in pairs], max(len(p[0]) for p in pairs))
    ta, tl = _pack([p[1] for p in pairs], max(len(p[1]) for p in pairs))
    full = al.align_batch(qa, ql, ta, tl, mode, 2, -1, -2)
    got = band.fill_banded(qa, ql, ta, tl, 2, -1, -2, band=512, mode=mode,
                           dash_free=True)
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(full, f)), f)


def test_dash_is_free_gap_in_fill():
    """A literal '-' costs no gap (team_alignment.cpp:25-28) in the general
    fill - which is why the mapper's host-side scans keep dash inputs off
    the dash_free specialization."""
    qa, ql = _pack(["AC-GT"], 8)
    xa, _ = _pack(["ACNGT"], 8)
    ta, tl = _pack(["ACGT"], 8)
    dash = band.fill_banded(qa, ql, ta, tl, 1, -1, -1, band=32)
    plain = band.fill_banded(xa, ql, ta, tl, 1, -1, -1, band=32)
    assert int(dash.score[0]) == 4
    assert int(dash.score[0]) > int(plain.score[0])


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_tiny_length_grid(mode):
    """Exhaustive tiny-length grid: every (ql, tl) parity combination and
    goals on the very first diagonals.  Band >= matrix, so certify's
    `whole` term holds and banded must equal the full DP."""
    rng = random.Random(3)
    pairs = [("".join(rng.choice("ACGT") for _ in range(a)),
              "".join(rng.choice("ACGT") for _ in range(b)))
             for a in range(1, 7) for b in range(1, 7)]
    qa, ql = _pack([p[0] for p in pairs], 8)
    ta, tl = _pack([p[1] for p in pairs], 8)
    want = al.align_batch(qa, ql, ta, tl, mode, 2, -1, -2)
    got = band.fill_banded(qa, ql, ta, tl, 2, -1, -2, band=32, mode=mode,
                           dash_free=True)
    cert = _certify(got, qa, ql, ta, tl, (2, -1, -2), 32, mode=mode)
    assert cert.all()
    for f in ("score", "goal_i", "goal_j"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


# --- the CUDA kernel's wrapper, without a card ---------------------------------

@pytest.mark.parametrize("band_w,want_parents", [(128, False), (128, True),
                                                 (2048, True), (20480, True)])
def test_kernel_result_shapes_match_twin(band_w, want_parents):
    """The FFI call's result shapes line up with the twin's outputs: the
    same (n + m_eff - 1, B, W/16) parents, and a global scratch only when
    the band's three rows overflow shared memory."""
    B, n, m = 3, 40, 90
    W = band.band_width(band_w)
    shapes, m_eff = band._kernel_shapes(B, n, m, W, want_parents)
    assert m_eff == min(m, n + W)
    twin = jax.eval_shape(
        lambda q, ql, t, tl, s: band.twin_fill(
            q, ql, t, tl, s, W=W, mode=0, want_parents=want_parents),
        jax.ShapeDtypeStruct((B, n), jnp.uint8),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B, m), jnp.uint8),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((3,), jnp.int32))
    for i, f in enumerate(("score", "goal_i", "goal_j")):
        assert shapes[i].shape == getattr(twin, f).shape
    if want_parents:
        assert shapes[3].shape == twin.parents.shape
        assert shapes[3].dtype == twin.parents.dtype
    threads, in_smem = band._launch_shape(W)
    assert threads == min(W, 1024) and threads % 32 == 0
    assert shapes[4].shape == ((1,) if in_smem else (B, 3 * W))
    assert in_smem == (W <= 16384)


@pytest.mark.parametrize("requested,W", [(1, 32), (32, 32), (100, 128),
                                         (128, 128), (257, 288)])
def test_band_width_rounding(requested, W):
    """Bands round up to LANE_MULTIPLE, which divides the mapper's 128, so
    128-rounded bands run unchanged; certify uses the same W."""
    assert band.band_width(requested) == W
    assert 128 % band.LANE_MULTIPLE == 0


def test_platform_dispatch_lowers_kernel_only_for_cuda():
    """One traced fill: lowered for the CPU it is the lax twin (no custom
    call); lowered for CUDA it is the kernel's FFI call and no scan."""
    args = (np.zeros((2, 16), np.uint8), np.array([16, 8], np.int32),
            np.zeros((2, 32), np.uint8), np.array([20, 8], np.int32),
            jnp.int32(1), jnp.int32(-1), jnp.int32(-1))

    def f(*a):
        return band.fill_banded(*a, band=64, mode=2, want_parents=True)

    traced = jax.jit(f).trace(*args)
    cpu = traced.lower(lowering_platforms=("cpu",)).as_text()
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "bioinfo1_band_fill" not in cpu and "while" in cpu
    assert "bioinfo1_band_fill" in cuda and "while" not in cuda


# --- on the card ---------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("want_parents", [False, True])
def test_kernel_matches_twin_on_gpu(gpu, mode, want_parents):
    """CUDA kernel == lax twin, bit for bit, with and without dash_free."""
    from bioinfo1_tpu.utils import simulate as sim
    rng = np.random.default_rng(mode)
    q, ql, t, tl = sim.region_pairs(rng, 16, 600, 1200)
    prm = np.array([1, -1, -1], np.int32)
    assert band.parity_mismatches(q, ql, t, tl, prm, band=128, mode=mode,
                                  want_parents=want_parents) == []


@pytest.mark.gpu
def test_map_step_runs_kernel_on_gpu(gpu):
    """The lowered score and -c steps call the kernel."""
    from bioinfo1_tpu.pipeline import device_map as dm
    assert dm.kernel_in_lowered_steps() == (True, True)
