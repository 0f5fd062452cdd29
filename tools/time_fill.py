#!/usr/bin/env python
"""Time the CUDA band-fill kernel against its lax twin on one GPU.

    python tools/time_fill.py [--reps 3] [--out results.json]

End to end through device_map.map_step (score-only) and map_step_cigar
(with parents and the traceback walk), on an E. coli-scale index, at the
shapes the mapper runs:
  (i)   B=256, 4,096 bp reads, region cap 8,192, W=128, score-only;
  (ii)  B=512 and B=384, 8 kb reads, W=256, with parents;
  (iii) B=32, 8 kb reads, W=2,048, with parents (realign-wide band);
  (iv)  B=64, 20 kb reads, W=512, with parents.
The twin leg swaps ops/band.fill_banded for the lax twin in a fresh jit of
the same step; both legs run in turns (kernel, twin, kernel, twin) in one
process.  It also times the lax LIS chain at (i) and (ii) and the lax
traceback walk at (ii), for later kernel decisions.  Times are host wall
clock around block_until_ready, after one compile-and-warm call; the card's
name and power limit are printed beside them.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from bioinfo1_tpu.index import builder  # noqa: E402
from bioinfo1_tpu.ops import band as band_ops  # noqa: E402
from bioinfo1_tpu.ops import chain as chain_ops  # noqa: E402
from bioinfo1_tpu.ops import match as match_ops  # noqa: E402
from bioinfo1_tpu.ops import minimizer as mz  # noqa: E402
from bioinfo1_tpu.ops import trace as tr  # noqa: E402
from bioinfo1_tpu.pipeline import device_map as dm  # noqa: E402
from bioinfo1_tpu.utils import simulate as sim  # noqa: E402

K, W_MIN = 15, 5
STATIC = ("k", "w", "mode", "budget", "region_cap", "oob_end_windows",
          "band", "shard_axis", "dash_free")

# name: (batch, read length, bucket width, region cap, band, with parents)
SHAPES = {
    "i": (256, 4096, 4096, 8192, 128, False),
    "ii-512": (512, 8000, 8192, 16384, 256, True),
    "ii-384": (384, 8000, 8192, 16384, 256, True),
    "iii": (32, 8000, 8192, 16384, 2048, True),
    "iv": (64, 20000, 24576, 49152, 512, True),
}


def twin_fill_banded(q, ql, t, tl, match, mismatch, gap, *, band, mode=0,
                     want_parents=False, dash_free=False):
    scoring = jnp.stack([jnp.asarray(x, jnp.int32)
                         for x in (match, mismatch, gap)])
    return band_ops.twin_fill(q, ql, t, tl, scoring,
                              W=band_ops.band_width(band), mode=mode,
                              want_parents=want_parents)


_STEPS = {}


def step_for(leg, cigar):
    """A separate jit of the step whose fill is the kernel or the twin (the
    fill is looked up when the step is traced, so it is patched first)."""
    band_ops.fill_banded = (KERNEL_FILL if leg == "kernel"
                            else twin_fill_banded)
    if (leg, cigar) not in _STEPS:
        body = (dm.map_step_cigar if cigar else dm.map_step).__wrapped__

        def step(*args, **kw):    # a function of its own: its own jit cache
            return body(*args, **kw)
        _STEPS[leg, cigar] = jax.jit(step, static_argnames=STATIC)
    return _STEPS[leg, cigar]


KERNEL_FILL = band_ops.fill_banded


def batch(genome, rng, B, read_len, width):
    recs = sim.simulate_reads(genome, [read_len] * B, rng)
    arr = np.zeros((B, width), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, (_, s) in enumerate(recs):
        b = np.frombuffer(s.encode("latin1"), np.uint8)[:width]
        arr[i, :len(b)] = b
        lens[i] = len(b)
    return jnp.asarray(arr), jnp.asarray(lens)


def timed(fn, reps):
    jax.block_until_ready(fn())                     # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return ts


@functools.partial(jax.jit, static_argnames=("budget",))
def chain_inputs(reads, lens, index, *, budget):
    """The (2B, N) match lists _map_core hands to lis_chain."""
    mres = mz.minimize_batch(reads, lens, K, W_MIN)
    L = reads.shape[1]
    expect = -(-2 * L // ((W_MIN + 1) * 128)) * 128 + 128
    keep_cap = min(mres.hashes.shape[1], budget, max(expect, budget // 2))
    q_hash, q_pos, q_keep, _ = match_ops.compact_queries(
        mres.hashes, mres.pos, mres.dedup_keep, keep_cap)
    got_f, got_r = match_ops.find_matches_combined(
        q_hash, q_pos, q_keep, index.key_hash, index.key_pos, index.cnt_fr,
        index.cnt_r2, index.bucket_off, index.shift, index.bsearch_steps,
        budget, index.cnt_shift)
    cat = functools.partial(jnp.concatenate, axis=0)
    return (cat([got_f.f_pos, got_r.f_pos]), cat([got_f.r_pos, got_r.r_pos]),
            cat([got_f.count, got_r.count]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found {dev.platform}")
    print(card, dev.device_kind, flush=True)
    genome = bench.make_data()[0]
    index = builder.build_index(genome.tobytes().decode("latin1"), K, W_MIN,
                                0.001)
    didx = dm.device_index_from_host(index)
    rng = np.random.default_rng(bench.SEED + 3)
    scoring = (jnp.int32(1), jnp.int32(-1), jnp.int32(-1))
    results = {"card": card, "device_kind": dev.device_kind,
               "reps": args.reps, "shapes": {}}
    for name in args.shapes.split(","):
        B, read_len, width, region_cap, W, cigar = SHAPES[name]
        reads, lens = batch(genome, rng, B, read_len, width)
        budget = max(512, -(-3 * width // (8 * 128)) * 128)
        kw = dict(k=K, w=W_MIN, mode=0, budget=budget,
                  region_cap=region_cap, band=W, dash_free=True)
        row = {"B": B, "read_len": read_len, "W": W, "parents": cigar}
        outs = {}
        for leg in ("kernel", "twin", "kernel", "twin"):
            step = step_for(leg, cigar)
            ts = timed(lambda: step(reads, lens, didx, *scoring, **kw),
                       args.reps)
            row.setdefault(leg, []).extend(ts)
            outs[leg] = jax.device_get(step(reads, lens, didx, *scoring,
                                            **kw))
        band_ops.fill_banded = KERNEL_FILL
        a, b = outs["kernel"], outs["twin"]
        same = all(np.array_equal(x, y) for x, y in
                   zip(jax.tree.leaves(a), jax.tree.leaves(b)))
        row["outputs_equal"] = bool(same)
        for leg in ("kernel", "twin"):
            row[leg + "_median_s"] = statistics.median(row[leg])
        # The fill alone on the step's own region shapes.
        q, ql, t, tl = [jnp.asarray(x) for x in
                        sim.region_pairs(rng, B, width, region_cap)]
        prm = jnp.asarray([1, -1, -1], jnp.int32)
        fkw = dict(W=W, mode=0, want_parents=cigar)
        kfill = jax.jit(functools.partial(band_ops.kernel_fill,
                                          dash_free=True, **fkw))
        tfill = jax.jit(functools.partial(band_ops.twin_fill, **fkw))
        for leg, f in (("kernel", kfill), ("twin", tfill)) * 2:
            row.setdefault("fill_" + leg + "_s", []).extend(
                timed(lambda: f(q, ql, t, tl, prm), args.reps))
        if name in ("i", "ii-512"):
            f, r, c = chain_inputs(reads, lens, didx, budget=budget)
            row["chain_shape"] = list(f.shape)
            row["chain_s"] = timed(lambda: chain_ops.lis_chain(f, r, c),
                                   args.reps)
        if name == "ii-512":
            fill = band_ops.fill_banded(q, ql, t, tl, *scoring, band=W,
                                        want_parents=True, dash_free=True)
            row["walk_s"] = timed(lambda: tr.pack_codes(tr.walk_parents(
                fill.parents, fill.goal_i, fill.goal_j, fill.score, q, t,
                *scoring, mode=0, band=W)), args.reps)
        results["shapes"][name] = row
        print(name, json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
