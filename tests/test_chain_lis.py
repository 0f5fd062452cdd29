"""Batched LIS chaining (ops/chain.lis_chain) vs the executable spec
(reference_model.find_lis), on the cases the chain stage meets: random
runs with jumps past the 5000 cap, hand-built edge cases, rows of very
different match counts in one batch, and repeat-copy structure."""

import random

import jax
import numpy as np

from bioinfo1_tpu import reference_model as rm
from bioinfo1_tpu.ops import chain as chain_ops


def _random_matches(seed, B, N):
    rng = random.Random(seed)
    f = np.zeros((B, N), np.int32)
    r = np.zeros((B, N), np.int32)
    cnt = np.zeros((B,), np.int32)
    for b in range(B):
        n = rng.randrange(0, N + 1)
        cnt[b] = n
        fp, rp = 1, 1
        for j in range(n):
            # Mix of ascending runs (chains) and random jumps, with some
            # gaps beyond the 5000 cap.
            if rng.random() < 0.7:
                fp += rng.randrange(1, 30)
                rp += rng.randrange(1, 30)
            else:
                fp = rng.randrange(1, 20000)
                rp = rng.randrange(1, 20000)
            f[b, j], r[b, j] = fp, rp
    return f, r, cnt


def _assert_matches_spec(f, r, cnt):
    got = jax.device_get(chain_ops.lis_chain(f, r, cnt))
    for b in range(len(cnt)):
        chain = rm.find_lis([(int(f[b, j]), int(r[b, j]))
                             for j in range(cnt[b])])
        assert got.length[b] == len(chain), b
        if chain:
            assert (got.q_start[b], got.t_start[b]) == chain[0], b
            assert (got.q_end[b], got.t_end[b]) == chain[-1], b
    return got


def test_lis_chain_matches_spec_random():
    _assert_matches_spec(*_random_matches(11, B=12, N=96))


def test_lis_chain_direct_cases():
    cases = [
        [(10, 5), (5, 8)],
        [(5, 5), (10, 8)],
        [(5, 5), (10, 6000)],
        [(1, 1), (2, 2), (3, 3), (2, 4), (4, 4)],
        [(7, 3)],
        [],
    ]
    N = 8
    B = len(cases)
    f = np.zeros((B, N), np.int32)
    r = np.zeros((B, N), np.int32)
    cnt = np.zeros((B,), np.int32)
    for i, c in enumerate(cases):
        for j, (ff, rr) in enumerate(c):
            f[i, j], r[i, j] = ff, rr
        cnt[i] = len(c)
    got = _assert_matches_spec(f, r, cnt)
    assert list(got.length) == [1, 2, 1, 4, 1, 0]


def test_lis_chain_mixed_counts_in_one_batch():
    """Both strands' rows share one call in the fused step (device_map):
    full rows next to near-empty ones must not change any row's result."""
    f, r, cnt = _random_matches(23, B=17, N=96)
    cnt[::2] = np.minimum(cnt[::2], 2)
    _assert_matches_spec(f, r, cnt)


def test_lis_chain_repeat_copies():
    """Repeat-copy structure (target offsets straddling the 5000 window)
    over long match lists."""
    rng = np.random.default_rng(5)
    B, N = 6, 400
    f = np.zeros((B, N), np.int32)
    r = np.zeros((B, N), np.int32)
    cnt = np.zeros((B,), np.int32)
    for i in range(B):
        n = int(rng.integers(N // 2, N + 1))
        cnt[i] = n
        fs = np.sort(rng.integers(1, 12000, n)).astype(np.int32)
        copies = rng.integers(0, 7, n).astype(np.int32)
        f[i, :n] = fs
        r[i, :n] = fs + copies * 5300 + rng.integers(-80, 80, n)
    got = _assert_matches_spec(f, r, cnt)
    assert (got.length > 0).all()
