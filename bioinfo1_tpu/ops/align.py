"""Batched anti-diagonal wavefront DP alignment (lax implementation).

Re-design of team::Align (team_alignment.cpp:49-350).  The reference fills
an (n+1)x(m+1) heap matrix cell-by-cell per read on one CPU thread; here one
parameterized recurrence runs all three modes over whole read batches: the
DP advances along anti-diagonals, keeping two previous diagonals as (B, n+1)
vectors, so each step is a handful of fused elementwise ops across the
batch.  ``align_batch`` is the full-matrix DP; ``align_banded_parents`` is
the banded twin of the CUDA fill kernel (ops/band.py) and its reference.

Semantics preserved exactly (see reference_model.align for the derivation):
  * linear gap, literal '-' characters cost 0 (team_alignment.cpp:25-28),
  * raw byte comparison for match/mismatch (case- and N-sensitive),
  * M > I > D tie priority via first-set/strictly-greater (104-114),
  * global: init i*gap borders, goal (n, m),
  * local: zero borders, clamp negatives, goal = first strictly-greater max
    in row-major scan order (171-199),
  * semiGlobal: zero borders, goal = rim argmax scanning the last column
    (i ascending) then the last row (j ascending, strictly greater) (265-278).

Traceback: the kernel can emit 2-bit parents packed 16-per-uint32 along each
diagonal; utils/cigar.py walks them on the host (CIGARs are only needed under
the -c flag, so the default mapping path is score-only).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

import numpy as _np

# numpy (not jnp) scalar: a module-level jnp constant would initialize the
# XLA backend at import time, breaking jax.distributed.initialize ordering.
_NEG = _np.int32(-(2**31) + 2)

MODE_GLOBAL, MODE_LOCAL, MODE_SEMIGLOBAL = 0, 1, 2
MODE_BY_NAME = {"global": MODE_GLOBAL, "local": MODE_LOCAL,
                "semiGlobal": MODE_SEMIGLOBAL}


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AlignOut:
    """score: (B,) int32; goal_i/goal_j: (B,) int32 traceback start cell.

    parents: packed 2-bit parent words, (n+m-1, B, ceil((n+1)/16)) uint32
    (diag d=2..n+m at index d-2, lane i at word i//16 bits 2*(i%16)), or a
    (0,0,0) placeholder when parents were not requested.
    """

    score: jax.Array
    goal_i: jax.Array
    goal_j: jax.Array
    parents: jax.Array


def _pack_parents(p: jax.Array, W: int) -> jax.Array:
    """(B, n1) int32 parents in {0,1,2} -> (B, W) uint32, 16 lanes/word."""
    B, n1 = p.shape
    pad = W * 16 - n1
    if pad:
        p = jnp.pad(p, ((0, 0), (0, pad)))
    p = p.reshape(B, W, 16).astype(jnp.uint32)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(p << shifts, axis=-1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnames=("mode", "want_parents"))
def align_batch(q_bytes: jax.Array, q_lens: jax.Array,
                t_bytes: jax.Array, t_lens: jax.Array,
                mode: int, match: jax.Array, mismatch: jax.Array,
                gap: jax.Array, want_parents: bool = False) -> AlignOut:
    """Align query rows to target rows.

    Args:
      q_bytes: (B, n) uint8 ASCII query regions, right-padded.
      q_lens:  (B,) int32 true region lengths (>= 1 for active rows).
      t_bytes: (B, m) uint8 ASCII target regions.
      t_lens:  (B,) int32.
      mode: MODE_GLOBAL / MODE_LOCAL / MODE_SEMIGLOBAL (static).
      match/mismatch/gap: int32 scoring scalars (traced; no recompiles).
    """
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    n1 = n + 1
    W = -(-n1 // 16)
    match = jnp.int32(match)
    mismatch = jnp.int32(mismatch)
    gap = jnp.int32(gap)
    init = gap if mode == MODE_GLOBAL else jnp.int32(0)
    q_lens = q_lens.astype(jnp.int32)
    t_lens = t_lens.astype(jnp.int32)

    lanes = jnp.arange(n1, dtype=jnp.int32)[None, :]        # (1, n1)
    rows = jnp.arange(B)

    # Lane i carries query char q[i-1]; lane 0 is the boundary row.
    q_sh = jnp.concatenate(
        [jnp.zeros((B, 1), dtype=q_bytes.dtype), q_bytes], axis=1)
    # indel() charges 0 for literal '-' (team_alignment.cpp:25-28).
    dash = jnp.uint8(ord("-"))
    del_cost = jnp.where(q_sh == dash, 0, gap).astype(jnp.int32)  # per lane

    h_prev2 = jnp.zeros((B, n1), dtype=jnp.int32)            # diag d=0
    h_prev = jnp.zeros((B, n1), dtype=jnp.int32)             # diag d=1
    h_prev = h_prev.at[:, 0].set(init)                       # cell (0,1)
    if n1 > 1:
        h_prev = h_prev.at[:, 1].set(init)                   # cell (1,0)
    tdiag = jnp.zeros((B, n1), dtype=jnp.uint8)
    tdiag = tdiag.at[:, 0].set(t_bytes[:, 0])                # t[j-1] for (0,1)... d=1

    # Carries for goal/score tracking.
    score0 = jnp.zeros((B,), dtype=jnp.int32)                # global: H(n_r,m_r)
    best0 = (jnp.full((B,), _NEG), jnp.zeros((B,), jnp.int32),
             jnp.zeros((B,), jnp.int32))                     # local (cost,i,j)
    # Semi rim carries start at the always-present boundary candidates
    # (0, m_r) and (n_r, 0), both H=0 under zero borders: the reference's
    # rim scans visit them first (team_alignment.cpp:265-278), and they sit
    # on diagonals d<2 that the scan below never processes when the region
    # is 1 wide/tall.
    col0 = (jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))
    row0 = (jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))

    def step(carry, d):
        h_prev2, h_prev, tdiag, score, best, colb, rowb = carry
        # tdiag[i] must hold t[d-1-i]; shift and inject t[d-1] at lane 0.
        tnew = jnp.take_along_axis(
            t_bytes, jnp.clip(d - 1, 0, m - 1)[None].repeat(B)[:, None],
            axis=1)[:, 0]
        tdiag = jnp.roll(tdiag, 1, axis=1).at[:, 0].set(tnew)

        sub = jnp.where(q_sh == tdiag, match, mismatch).astype(jnp.int32)
        ins_cost = jnp.where(tdiag == dash, 0, gap).astype(jnp.int32)

        diag_v = jnp.roll(h_prev2, 1, axis=1) + sub          # (i-1, j-1)
        up_v = jnp.roll(h_prev, 1, axis=1) + del_cost        # (i-1, j)
        left_v = h_prev + ins_cost                           # (i,   j-1)

        # M > I > D first-set / strictly-greater priority.
        h = diag_v
        parent = jnp.zeros_like(h)
        h = jnp.where(left_v > h, left_v, h)
        parent = jnp.where(left_v > diag_v, 1, parent)
        take_d = up_v > h
        h = jnp.where(take_d, up_v, h)
        parent = jnp.where(take_d, 2, parent)

        # Boundary rows/columns of the DP matrix.
        h = jnp.where(lanes == 0, d * init, h)               # cell (0, d)
        h = jnp.where(lanes == d, lanes * init, h)           # cell (d, 0)
        if mode == MODE_LOCAL:
            h = jnp.maximum(h, 0)

        # --- goal tracking ---
        if mode == MODE_GLOBAL:
            hit = d == (q_lens + t_lens)
            val = h[rows, jnp.clip(q_lens, 0, n1 - 1)]
            score = jnp.where(hit, val, score)
        elif mode == MODE_LOCAL:
            in_diag = ((lanes >= 1) & (lanes <= q_lens[:, None])
                       & ((d - lanes) >= 1) & ((d - lanes) <= t_lens[:, None]))
            cand = jnp.where(in_diag, h, _NEG)
            c = jnp.max(cand, axis=1)
            ci = jnp.min(jnp.where(cand == c[:, None], lanes, n1), axis=1)
            cj = d - ci
            bc, bi, bj = best
            take = (c > bc) | ((c == bc) & ((ci < bi) | ((ci == bi) & (cj < bj))))
            best = (jnp.where(take, c, bc), jnp.where(take, ci, bi),
                    jnp.where(take, cj, bj))
        else:  # semiGlobal rim tracking
            # Last column: cell (d - m_r, m_r); ascending d => ascending i,
            # strictly-greater keeps the smallest i among maxima.
            i_col = d - t_lens
            v_col = h[rows, jnp.clip(i_col, 0, n1 - 1)]
            ok_col = (i_col >= 0) & (i_col <= q_lens)
            cc, ci_ = colb
            take = ok_col & (v_col > cc)
            colb = (jnp.where(take, v_col, cc), jnp.where(take, i_col, ci_))
            # Last row: cell (n_r, d - n_r).
            j_row = d - q_lens
            v_row = h[rows, jnp.clip(q_lens, 0, n1 - 1)]
            ok_row = (j_row >= 0) & (j_row <= t_lens)
            rc_, rj_ = rowb
            take = ok_row & (v_row > rc_)
            rowb = (jnp.where(take, v_row, rc_), jnp.where(take, j_row, rj_))

        packed = _pack_parents(parent, W) if want_parents else jnp.zeros(
            (B, 0), dtype=jnp.uint32)
        return (h_prev, h, tdiag, score, best, colb, rowb), packed

    ds = jnp.arange(2, n + m + 1, dtype=jnp.int32)
    (h_prev2, h_prev, tdiag, score, best, colb, rowb), parents = jax.lax.scan(
        step, (h_prev2, h_prev, tdiag, score0, best0, col0, row0), ds)

    if mode == MODE_GLOBAL:
        out_score, gi, gj = score, q_lens, t_lens
    elif mode == MODE_LOCAL:
        bc, bi, bj = best
        hit = bc > _NEG
        out_score = jnp.where(hit, bc, 0)
        gi = jnp.where(hit, bi, 0)
        gj = jnp.where(hit, bj, 0)
    else:
        cc, ci_ = colb
        rc_, rj_ = rowb
        row_wins = rc_ > cc
        out_score = jnp.where(row_wins, rc_, cc)
        gi = jnp.where(row_wins, q_lens, ci_)
        gj = jnp.where(row_wins, rj_, t_lens)

    if not want_parents:
        parents = jnp.zeros((0, 0, 0), dtype=jnp.uint32)
    return AlignOut(score=out_score, goal_i=gi, goal_j=gj, parents=parents)


@functools.partial(jax.jit, static_argnames=("band", "mode", "want_parents"))
def align_banded_parents(q_bytes: jax.Array, q_lens: jax.Array,
                         t_bytes: jax.Array, t_lens: jax.Array,
                         match: jax.Array, mismatch: jax.Array,
                         gap: jax.Array, band: int = 256,
                         mode: int = MODE_GLOBAL,
                         want_parents: bool = True) -> AlignOut:
    """Banded alignment (all 3 modes), optionally with 2-bit parents in band
    coordinates.

    Lane l of anti-diagonal d holds offset o = 2l - W + (d & 1), i.e. cell
    i = (d - o) / 2, j = (d + o) / 2; the band is W lanes (band rounded up
    to 16) wide, fixed lane shifts, no per-read steering.  Parents pack
    16-per-uint32 along the band, (steps, B, W/16) with diag d at row d-2 -
    W/(n+1) times smaller than the full-matrix parents, which is what makes
    -c affordable on long reads (the reference heap-allocates the full cell
    matrix per read, team_alignment.cpp:77).  ``want_parents=False`` stacks
    no parents (a (0, 0, 0) placeholder) - the score-only path.

    This is the twin of the CUDA kernel in native/band_fill.cu (reached
    through ops/band.fill_banded), which matches it bit for bit.

    EXACTNESS: with band.certify(..., strict=True) the traceback is
    byte-identical to the full DP's: every cell of the canonical M>I>D path
    keeps its full-DP value in the banded sweep, and masked (out-of-band)
    competitors can only lose harder under the first-set strictly-greater
    rule.  Uncertified reads must be re-run through align_batch.
    """
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    W = -(-band // 16) * 16
    half = W // 2
    m_eff = min(m, n + W)
    PW = W // 16
    match = jnp.int32(match)
    mismatch = jnp.int32(mismatch)
    gap = jnp.int32(gap)
    init = gap if mode == MODE_GLOBAL else jnp.int32(0)
    NEG = jnp.int32(-(2**30))
    dash = jnp.uint8(ord("-"))
    ql = q_lens.astype(jnp.int32)
    tl = jnp.minimum(t_lens.astype(jnp.int32), m_eff)

    lanes = jnp.arange(W, dtype=jnp.int32)[None, :]          # (1, W)

    # Band-state seeds for d=1: lane l holds q[i(l)-1]
    # with i(l) = W/2 - l, and t[j(l)-1] with j(l) = l - W/2 + 1.
    qi0 = jnp.clip(half - lanes - 1, 0, n - 1)
    qd = jnp.where(half - lanes >= 1,
                   jnp.take_along_axis(q_bytes, jnp.broadcast_to(
                       qi0, (B, W)), axis=1), 0).astype(jnp.int32)
    tj0 = jnp.clip(lanes - half, 0, m_eff - 1)
    td = jnp.where(lanes - half >= 0,
                   jnp.take_along_axis(t_bytes, jnp.broadcast_to(
                       tj0, (B, W)), axis=1), 0).astype(jnp.int32)

    h2 = jnp.where(lanes == half, 0, NEG) * jnp.ones((B, 1), jnp.int32)
    h1 = jnp.where((lanes == half) | (lanes == half - 1), init, NEG) \
        * jnp.ones((B, 1), jnp.int32)

    score0 = jnp.zeros((B,), jnp.int32)
    neg0 = jnp.full((B,), NEG, jnp.int32)
    zero0 = jnp.zeros((B,), jnp.int32)

    def step(carry, d):
        h2, h1, qd, td, score, bc, bi, bj, cc, ci, rc, rj = carry
        p = d & 1
        i0 = (d + W) // 2
        j0 = d - i0

        qnew = q_bytes[:, jnp.clip(i0 - 1, 0, n - 1)].astype(jnp.int32)
        qd_shift = jnp.roll(qd, 1, axis=1).at[:, 0].set(qnew)
        qd = jnp.where(p == 0, qd_shift, qd)
        tnew = t_bytes[:, jnp.clip(j0 + W - 2, 0, m_eff - 1)].astype(
            jnp.int32)
        td_shift = jnp.roll(td, -1, axis=1).at[:, W - 1].set(tnew)
        td = jnp.where(p == 0, td, td_shift)

        h1_m = jnp.roll(h1, -1, axis=1).at[:, W - 1].set(NEG)
        h1_p = jnp.roll(h1, 1, axis=1).at[:, 0].set(NEG)
        up = jnp.where(p == 0, h1, h1_m)
        left = jnp.where(p == 0, h1_p, h1)

        sub = jnp.where(qd == td, match, mismatch)
        del_cost = jnp.where(qd == jnp.int32(ord("-")), 0, gap)
        ins_cost = jnp.where(td == jnp.int32(ord("-")), 0, gap)
        diag_v = h2 + sub
        left_v = left + ins_cost
        up_v = up + del_cost

        # M > I > D first-set / strictly-greater (team_alignment.cpp:104-114).
        h = diag_v
        parent = jnp.zeros_like(h)
        h = jnp.where(left_v > h, left_v, h)
        parent = jnp.where(left_v > diag_v, 1, parent)
        take_d = up_v > h
        h = jnp.where(take_d, up_v, h)
        parent = jnp.where(take_d, 2, parent)

        i_lane = i0 - lanes
        j_lane = d - i_lane
        if mode == MODE_LOCAL:
            h = jnp.maximum(h, 0)
        h = jnp.where(i_lane == 0, j_lane * init, h)
        h = jnp.where(j_lane == 0, i_lane * init, h)
        h = jnp.where((i_lane < 0) | (j_lane < 0), NEG, h)

        if mode == MODE_GLOBAL:
            hit = d == (ql + tl)
            lstar = (tl - ql + W - p) // 2
            val = jnp.sum(jnp.where(lanes == lstar[:, None], h, 0), axis=1)
            score = jnp.where(hit, val, score)
        elif mode == MODE_LOCAL:
            # In-band argmax, reference row-major-first tie order
            # (team_alignment.cpp:185-192): on one anti-diagonal the
            # smallest i sits at the largest lane; across diagonals equal
            # (cost, i) keeps the earlier d (smaller j).
            valid = ((i_lane >= 1) & (i_lane <= ql[:, None])
                     & (j_lane >= 1) & (j_lane <= tl[:, None]))
            cand = jnp.where(valid, h, NEG)
            c = jnp.max(cand, axis=1)
            lmax = jnp.max(jnp.where(cand == c[:, None], lanes, -1), axis=1)
            i_cand = i0 - lmax
            take = (c > NEG) & ((c > bc) | ((c == bc) & (i_cand < bi)))
            bc = jnp.where(take, c, bc)
            bi = jnp.where(take, i_cand, bi)
            bj = jnp.where(take, d - i_cand, bj)
        else:
            i_col = d - tl
            l_col = i0 - i_col
            ok_col = ((i_col >= 0) & (i_col <= ql)
                      & (l_col >= 0) & (l_col < W))
            v_col = jnp.sum(
                jnp.where(lanes == l_col[:, None], h, 0), axis=1)
            take = ok_col & (v_col > cc)
            cc = jnp.where(take, v_col, cc)
            ci = jnp.where(take, i_col, ci)
            j_row = d - ql
            l_row = i0 - ql
            ok_row = ((j_row >= 0) & (j_row <= tl)
                      & (l_row >= 0) & (l_row < W))
            v_row = jnp.sum(
                jnp.where(lanes == l_row[:, None], h, 0), axis=1)
            take = ok_row & (v_row > rc)
            rc = jnp.where(take, v_row, rc)
            rj = jnp.where(take, j_row, rj)

        packed = _pack_parents(parent, PW) if want_parents else None
        return (h1, h, qd, td, score, bc, bi, bj, cc, ci, rc, rj), packed

    ds = jnp.arange(2, n + m_eff + 1, dtype=jnp.int32)
    carry0 = (h2, h1, qd, td, score0, neg0, zero0, zero0,
              zero0, zero0, zero0, zero0)
    (_, _, _, _, score, bc, bi, bj, cc, ci, rc, rj), parents = jax.lax.scan(
        step, carry0, ds)
    if not want_parents:
        parents = jnp.zeros((0, 0, 0), dtype=jnp.uint32)
    if mode == MODE_GLOBAL:
        return AlignOut(score=score, goal_i=ql, goal_j=tl, parents=parents)
    if mode == MODE_LOCAL:
        hit = bc > NEG
        return AlignOut(score=jnp.where(hit, bc, 0),
                        goal_i=jnp.where(hit, bi, 0),
                        goal_j=jnp.where(hit, bj, 0), parents=parents)
    row_wins = rc > cc
    return AlignOut(score=jnp.where(row_wins, rc, cc),
                    goal_i=jnp.where(row_wins, ql, ci),
                    goal_j=jnp.where(row_wins, rj, tl), parents=parents)
