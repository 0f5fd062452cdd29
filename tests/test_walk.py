"""Lockstep traceback walk (ops/trace.walk_parents) over banded parents vs
the host spec walk (utils/cigar.traceback), and the native CIGAR decoder vs
the numpy spec decoder on the walk's packed codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bioinfo1_tpu.ops import band
from bioinfo1_tpu.ops import trace as tr
from bioinfo1_tpu.ops.trace import unpack_codes_np
from bioinfo1_tpu.utils import cigar as cg
from bioinfo1_tpu.utils import simulate as sim

_NAMES = {0: "global", 1: "local", 2: "semiGlobal"}


def _walk(rng, B, n, W, mode):
    q, ql, t, tl = sim.region_pairs(rng, B, n, 2 * n)
    out = band.fill_banded(q, ql, t, tl, 1, -1, -1, band=W, mode=mode,
                           want_parents=True)
    packed = jax.device_get(tr.pack_codes(tr.walk_parents(
        out.parents, out.goal_i, out.goal_j, out.score,
        jnp.asarray(q), jnp.asarray(t), 1, -1, -1, mode=mode,
        band=band.band_width(W))))
    return q, ql, t, tl, jax.device_get(out), packed


def test_walk_matches_host_traceback():
    rng = np.random.default_rng(1)
    B, n, W = 8, 384, 128
    for mode in (0, 1, 2):
        q, ql, t, tl, out, packed = _walk(rng, B, n, W, mode)
        codes = unpack_codes_np(packed)
        par = np.asarray(out.parents)
        name = _NAMES[mode]
        for b in range(B):
            qs = q[b, :ql[b]].tobytes().decode("latin1")
            ts = t[b, :tl[b]].tobytes().decode("latin1")
            want = cg.traceback(par[:, b, :], qs, ts, int(out.goal_i[b]),
                                int(out.goal_j[b]), name,
                                int(out.score[b]), 1, -1, -1, band=W)
            got = cg.cigar_from_codes(codes[:, b], name, int(out.goal_i[b]),
                                      int(out.goal_j[b]), int(ql[b]),
                                      int(tl[b]))
            assert got == want, (name, b)


def test_native_decoder_matches_spec_decoder():
    from bioinfo1_tpu import native
    rng = np.random.default_rng(2)
    B, n, W = 6, 256, 128
    q, ql, t, tl, out, packed = _walk(rng, B, n, W, 0)
    idxs = np.arange(B, dtype=np.int32)
    nat = native.cigar_rle_batch(packed, idxs, out.goal_i, out.goal_j, ql,
                                 tl, "global", sam_convention=False,
                                 local_target_begin_end=False)
    if nat is None:
        pytest.skip("native library not built")
    cigs, _ = nat
    codes = unpack_codes_np(packed)
    for b in range(B):
        want, _ = cg.cigar_from_codes(codes[:, b], "global",
                                      int(out.goal_i[b]), int(out.goal_j[b]),
                                      int(ql[b]), int(tl[b]))
        assert cigs[b] == want, b
