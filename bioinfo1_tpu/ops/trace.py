"""On-device traceback walk over packed parent diagonals.

The fills leave 2-bit parents on the device ((S, B, PW) uint32, 16
lanes/word).  Fetching that tensor to walk it on the host costs two ways:
the device->host transfer (17-269 MB per batch) and a serial Python walk
(~10^4 loop iterations per read).  This walk runs as ONE loop over the whole
batch instead: each step gathers one parent word per read and advances every
read's (i, j) cursor in lockstep; the fetched result is a packed op-code
tensor (~300 KB) that the host merely run-length encodes (native/cigar.cpp,
spec: utils/cigar.cigar_from_codes).

Walk semantics mirror utils/cigar.traceback exactly (which mirrors the
reference, team_alignment.cpp:122-161/201-238/286-335):
  * global/semiGlobal: walk to (0,0); boundary rules i==0 -> I, j==0 -> D,
  * local: maintain the running cost and stop at 0 (literal '-' edges cost
    0, team_alignment.cpp:25-28),
  * op codes: 0=M, 1=I, 2=D, 255=done.

Supports both parent layouts: full (lane = i) and banded (lane =
(j - i + band - (d & 1)) / 2, see ops/band.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

OP_M, OP_I, OP_D, OP_DONE = 0, 1, 2, 255


@functools.partial(jax.jit, static_argnames=("mode", "band"))
def walk_parents(parents: jax.Array, goal_i: jax.Array, goal_j: jax.Array,
                 score: jax.Array, q_bytes: jax.Array, t_bytes: jax.Array,
                 match: jax.Array, mismatch: jax.Array, gap: jax.Array,
                 mode: int, band: int = 0) -> jax.Array:
    """(steps, B) uint8 op codes, goal -> origin order.

    Args:
      parents: (S, B, PW) uint32 packed parents, 16 lanes per word, diag d
        at row d-2.
      goal_i/goal_j: (B,) traceback start cells.
      score: (B,) DP scores (local mode's stop counter; ignored otherwise).
      q_bytes/t_bytes: (B, n)/(B, m) region bytes (local edge costs).
      mode: 0 global / 1 local / 2 semiGlobal (static).
      band: 0 for full-layout parents, else the band width W (static).
    """
    S, B, PW = parents.shape
    rows = jnp.arange(B, dtype=jnp.int32)
    match = jnp.int32(match)
    mismatch = jnp.int32(mismatch)
    gap = jnp.int32(gap)
    dash = jnp.int32(ord("-"))
    qn = q_bytes.shape[1]
    tm = t_bytes.shape[1]

    # One element per read per step, gathered by 3-D coordinate: a linear
    # index into the flattened tensor can overflow int32 at wide bands on
    # large batches.
    gdn = jax.lax.GatherDimensionNumbers(
        offset_dims=(), collapsed_slice_dims=(0, 1, 2),
        start_index_map=(0, 1, 2))

    def gather3(r, lane_w):
        starts = jnp.stack([r, rows, lane_w], axis=1)        # (B, 3)
        return jax.lax.gather(parents, starts, gdn,
                              slice_sizes=(1, 1, 1), mode="clip")

    def parent_at(i, j):
        d = i + j
        if band:
            lane = (j - i + band - (d & 1)) >> 1
        else:
            lane = i
        word = gather3(jnp.clip(d - 2, 0, S - 1), lane >> 4)
        return ((word >> (2 * (lane & 15).astype(jnp.uint32)))
                & 3).astype(jnp.int32)

    def byte_at(arr, pos, width):
        idx = rows * width + jnp.clip(pos, 0, width - 1)
        return jnp.take(arr.reshape(-1), idx).astype(jnp.int32)

    def step_once(carry):
        i, j, cost = carry
        p_in = parent_at(i, j)
        if mode == 1:  # local: stop at cost 0
            active = cost > 0
            p = p_in
            qc = byte_at(q_bytes, i - 1, qn)
            tc = byte_at(t_bytes, j - 1, tm)
            edge = jnp.where(
                p == OP_M, jnp.where(qc == tc, match, mismatch),
                jnp.where(p == OP_I,
                          jnp.where(tc == dash, 0, gap),
                          jnp.where(qc == dash, 0, gap)))
            cost = jnp.where(active, cost - edge, cost)
        else:
            active = (i > 0) | (j > 0)
            p = jnp.where(i == 0, OP_I, jnp.where(j == 0, OP_D, p_in))
        code = jnp.where(active, p, OP_DONE).astype(jnp.uint8)
        di = jnp.where((p == OP_M) | (p == OP_D), 1, 0)
        dj = jnp.where((p == OP_M) | (p == OP_I), 1, 0)
        i = jnp.where(active, i - di, i)
        j = jnp.where(active, j - dj, j)
        return (i, j, cost), code

    # 4 walk steps per loop iteration: the walk is a serial chain of tiny
    # gathers, and the per-iteration loop overhead rivals the gather
    # itself; unrolling quarters the iteration count (trailing over-steps
    # past the origin emit OP_DONE and are ignored by the RLE).  The loop
    # EXITS once every read is done (lax.while_loop + in-place buffer
    # updates): real paths end at goal_i+goal_j steps, ~20% short of the
    # padded step count, and mixed buckets' short reads finish earlier
    # still.  The buffer is pre-filled with OP_DONE so skipped iterations
    # read as finished.
    UNROLL = 4
    def step(carry):
        codes = []
        for _k in range(UNROLL):
            carry, c = step_once(carry)
            codes.append(c)
        return carry, jnp.stack(codes)

    carry0 = (goal_i.astype(jnp.int32), goal_j.astype(jnp.int32),
              score.astype(jnp.int32))
    n_iter = -(-(S + 2) // UNROLL)
    buf0 = jnp.full((n_iter, UNROLL, B), OP_DONE, jnp.uint8)

    def any_active(c):
        i, j, cost = c
        if mode == 1:
            return jnp.any(cost > 0)
        return jnp.any((i > 0) | (j > 0))

    def cond(state):
        carry, it, _ = state
        return (it < n_iter) & any_active(carry)

    def body(state):
        carry, it, buf = state
        carry, codes = step(carry)
        buf = jax.lax.dynamic_update_slice(buf, codes[None], (it, 0, 0))
        return carry, it + 1, buf

    _, _, codes = jax.lax.while_loop(cond, body, (carry0, jnp.int32(0), buf0))
    return codes.reshape(n_iter * UNROLL, -1)


@jax.jit
def pack_codes(codes: jax.Array) -> jax.Array:
    """Pack (S, B) op codes 4-per-byte for the device->host fetch.

    Codes are 2 bits of information ({M, I, D, done}); shipping them as one
    byte each quadruples the device->host fetch.  done (255) maps to 3;
    rows are padded with done.  Inverse: unpack_codes_np.
    """
    S, B = codes.shape
    s_pad = -(-S // 4) * 4
    c = jnp.minimum(codes.astype(jnp.uint32), 3)
    c = jnp.concatenate(
        [c, jnp.full((s_pad - S, B), 3, jnp.uint32)], axis=0)
    c = c.reshape(s_pad // 4, 4, B)
    shifts = (2 * jnp.arange(4, dtype=jnp.uint32))[None, :, None]
    return jnp.sum(c << shifts, axis=1).astype(jnp.uint8)


def unpack_codes_np(packed) -> "np.ndarray":
    """Host inverse of pack_codes: (S4, B) uint8 -> (4*S4, B) op codes
    (vectorized numpy; 3 maps back to done=255).  Trailing done padding is
    harmless - the RLE stops at the first done code."""
    import numpy as np
    p = np.asarray(packed)
    s4, B = p.shape
    out = np.empty((s4, 4, B), np.uint8)
    for k in range(4):
        out[:, k, :] = (p >> (2 * k)) & 3
    out = out.reshape(4 * s4, B)
    return np.where(out == 3, np.uint8(OP_DONE), out)
