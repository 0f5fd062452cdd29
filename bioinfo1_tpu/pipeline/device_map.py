"""Fully fused on-device map step: reads in, mapping coordinates + scores out.

This is the performance path and the unit of distribution.  One jit traces
the whole per-batch pipeline - minimizer sweep, fwd/rev index lookup, LIS
chaining, strand selection, region extraction by on-device gather, and the
banded anti-diagonal alignment - with no host round-trips between stages
(the host pipeline in pipeline/mapper.py stages through the host for the
CIGAR/bug-compat paths; this one is score-only, which is exactly what PAF
emission needs when -c is off).

Multi-chip: `shard_map` over the batch axis with the index replicated - see
bioinfo1_tpu/parallel/shard.py.  The reference's analog is the OpenMP
parallel-for over reads (team_mapper.cpp:596) with its shared in-RAM index.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp

from bioinfo1_tpu.ops import align as al
from bioinfo1_tpu.ops import band as band_ops
from bioinfo1_tpu.ops import chain as chain_ops
from bioinfo1_tpu.ops import match as match_ops
from bioinfo1_tpu.ops import minimizer as mz


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceIndex:
    """Device-resident replicated reference index (combined-table layout).

    All (hash, strand, pos) entries of BOTH strand indexes live in one
    lexicographically sorted table (fwd entries first within a hash run);
    cnt_fr packs the per-strand run sizes (fwd low bits, rev above
    ``cnt_shift``) at each run's first entry, so ONE lookup + ONE count
    gather serve both strands.  bucket_off[b] is the table offset of the
    first hash with top bits b (hash >> shift == b): a probe narrows to its
    bucket with two O(1) gathers and finishes with `bsearch_steps`
    binary-search rounds (log2 of the largest bucket - 3 for E. coli at the
    24-bit directory).

    ref_bytes stacks the forward and reverse-complement strand sequences as
    (2, ref_pad) uint8 so strand selection is a row index.

    shift/bsearch_steps/cnt_shift are static metadata (jit specialization
    keys).  cnt_shift=0 is the unpacked fallback for pathological indexes
    whose max run lengths cannot share 32 bits: cnt_fr then holds fwd
    counts and cnt_r2 (a size-1 dummy otherwise) the rev counts.
    """

    key_hash: jax.Array       # (U,) uint32 sorted, padded with 0xFFFFFFFF
    key_pos: jax.Array        # (U,) int32 1-based strand positions
    cnt_fr: jax.Array         # (U,) uint32 packed counts at hash-run starts
    cnt_r2: jax.Array         # (1,) dummy, or (U,) int32 when cnt_shift=0
    bucket_off: jax.Array     # (2^bb + 1,) int32
    ref_bytes: jax.Array      # (2, ref_pad) uint8
    ref_len: jax.Array        # () int32
    shift: int = dataclasses.field(default=0, metadata=dict(static=True))
    bsearch_steps: int = dataclasses.field(default=21,
                                           metadata=dict(static=True))
    cnt_shift: int = dataclasses.field(default=16,
                                       metadata=dict(static=True))
    # Hash-range sharding (sharded_device_index_from_host): device d of the
    # mesh holds hashes [d*shard_range, (d+1)*shard_range) and the lookup
    # arrays carry a leading device axis.  0 = replicated layout.
    shard_range: int = dataclasses.field(default=0,
                                         metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MapOut:
    """Per-read mapping summary (all (B,) int32 unless noted).

    mapped: bool; is_fwd: bool; q_begin/q_end/t_begin/t_end: 0-based
    inclusive region bounds (strand coordinates); score: DP score;
    overflow: match budget exceeded (host must retry bigger); need: the
    EXACT per-read match-list length (max over strands, pre-truncation) -
    overflowed reads retry at a budget covering it in ONE hop instead of
    doubling blindly; inexact: banded-certificate miss - the score is
    only a lower bound and the host reruns the read through the
    realign-only pass at the band that bound proves certifiable
    (pipeline/mapper._realign_bucket; always False when band == 0).
    """

    mapped: jax.Array
    is_fwd: jax.Array
    q_begin: jax.Array
    q_end: jax.Array
    t_begin: jax.Array
    t_end: jax.Array
    score: jax.Array
    overflow: jax.Array
    need: jax.Array
    inexact: jax.Array


def device_index_from_host(index, pad_to_pow2: bool = True) -> DeviceIndex:
    """Pack an index.builder.IndexArrays into the combined device layout.

    The host-side merge (combined sorted table, fwd-before-rev within each
    hash run, packed per-strand counts) lives in _host_combined_table,
    shared with the sharded packer."""
    import numpy as np

    ks, ps, cnt_fr0, cnt_r20, cnt_shift = _host_combined_table(index)
    U = len(ks)
    Up = 8
    while Up < U:
        Up *= 2
    if not pad_to_pow2:
        Up = max(U, 1)
    cnt_fr = np.zeros(Up, cnt_fr0.dtype)
    cnt_fr[:U] = cnt_fr0
    if cnt_shift == 0:
        cnt_r2 = np.zeros(Up, np.int32)
        cnt_r2[:U] = cnt_r20
    else:
        cnt_r2 = cnt_r20
    # Sentinel pads sort after every real hash; their counts are 0, so a
    # probe landing on them reports no hits.
    ksp = np.full(Up, 0xFFFFFFFF, np.uint32)
    ksp[:U] = ks
    psp = np.zeros(Up, np.int32)
    psp[:U] = ps

    # Bucket directory over the top bb hash bits.  24 bits (64 MB) instead
    # of 22 shaves one binary-search round at E. coli scale; the size guard
    # keeps the directory within ~16x the table itself for small genomes.
    # Built ON DEVICE (scatter-count + cumsum over the uploaded key table):
    # the host-side 16M-probe searchsorted and the 64 MB directory upload
    # were the two most expensive pieces of index packing.
    hash_bits = 2 * int(index.k)
    # Direct-address mode: a directory over the WHOLE hash space turns the
    # lookup into 2 gathers (run start + size), no binary search and no
    # key-equality probe.  Worth its HBM (4 bytes per possible hash: 4 GB
    # at k=15) only for genome-scale indexes; tiny test indexes keep the
    # compact bucketed directory.  BIOINFO1_DIRECT_INDEX=0/1 overrides.
    env_direct = os.environ.get("BIOINFO1_DIRECT_INDEX")
    if env_direct is None:
        direct = hash_bits <= 30 and U >= (1 << 20)
    else:
        direct = env_direct not in ("0", "false")
        if direct and hash_bits > 30:
            raise ValueError(
                f"BIOINFO1_DIRECT_INDEX=1 needs 2*k <= 30 hash bits (got "
                f"{hash_bits}): a 2^{hash_bits}-entry directory would not "
                "fit, and int32 bucket indexes would wrap")
    if direct:
        bb, shift, steps = hash_bits, 0, 0
    else:
        bb = max(1, min(24, hash_bits, (max(U, 2) - 1).bit_length() + 4))
        shift = max(0, hash_bits - bb)
    key_dev = jnp.asarray(ksp)
    bo_dev, _ = _bucket_directory(key_dev, jnp.int32(U), bb=bb, shift=shift)
    if not direct:
        # max bucket (-> binary-search depth) computed host-side from the
        # table already in host memory: no device fetch in the pack path.
        if U:
            max_bucket = int(np.bincount(ks >> np.uint32(shift),
                                         minlength=1).max())
        else:
            max_bucket = 1
        steps = max(1, int(np.ceil(np.log2(max(max_bucket, 1) + 1))))

    L = int(index.ref_len)
    cap = 16
    while cap < L:
        cap *= 2
    ref = np.zeros((2, cap), dtype=np.uint8)
    ref[0, :L] = np.frombuffer(index.ref_fwd_seq.encode("latin1"),
                               dtype=np.uint8)
    ref[1, :L] = np.frombuffer(index.ref_rev_seq.encode("latin1"),
                               dtype=np.uint8)
    return DeviceIndex(
        key_hash=key_dev, key_pos=jnp.asarray(psp),
        cnt_fr=jnp.asarray(cnt_fr), cnt_r2=jnp.asarray(cnt_r2),
        bucket_off=bo_dev,
        ref_bytes=jnp.asarray(ref), ref_len=jnp.int32(L),
        shift=shift, bsearch_steps=steps, cnt_shift=cnt_shift)


def sharded_device_index_from_host(index, n_shards: int) -> DeviceIndex:
    """Pack the index with the LOOKUP structures hash-range-sharded over
    ``n_shards`` devices (BASELINE north star: "sharded across a multi-host
    pod when large").

    Shard d owns hashes [d*S, (d+1)*S) with S = 2^(2k)/n_shards: the
    combined sorted table rows in that range (padded to the largest shard)
    plus a REBASED direct-address directory over the range - per-device
    directory HBM drops from 4*4^k to 4*4^k/D bytes, which is what caps
    replicated indexes (4 GB/replica at k=15).  Always direct-address (the
    directory is the reason to shard; needs 2*k <= 30).  ref_bytes stays
    replicated - it costs 2 bytes/base against the index's ~16.

    Arrays carry a leading (n_shards, ...) axis; place with
    parallel.shard.shard_index and run map_step with shard_axis set.
    Lookup results are bit-identical to the replicated layout
    (ops/match.find_matches_combined_sharded).
    """
    import numpy as np

    hash_bits = 2 * int(index.k)
    if hash_bits > 30:
        raise ValueError(f"sharded index needs 2*k <= 30 bits (k={index.k})")
    if (1 << hash_bits) % n_shards:
        raise ValueError(f"n_shards={n_shards} must divide the hash space")
    # Host-side combined sorted table + packed counts (same layout as the
    # replicated packer), then sliced by hash range.
    ks, ps, cnt_fr, cnt_r2, cnt_shift = _host_combined_table(index)
    U = len(ks)
    S = (1 << hash_bits) // n_shards
    bounds = np.searchsorted(ks[:U], np.arange(n_shards + 1,
                                               dtype=np.uint64) * S)
    sizes = np.diff(bounds)
    cap = max(int(sizes.max()), 1)
    kh = np.full((n_shards, cap), 0xFFFFFFFF, np.uint32)
    kp = np.zeros((n_shards, cap), np.int32)
    cf = np.zeros((n_shards, cap), cnt_fr.dtype)
    c2 = np.zeros((n_shards, cap if cnt_shift == 0 else 1), np.int32)
    bo = np.zeros((n_shards, S + 1), np.int32)
    for d in range(n_shards):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        n = hi - lo
        kh[d, :n] = ks[lo:hi]
        kp[d, :n] = ps[lo:hi]
        cf[d, :n] = cnt_fr[lo:hi]
        if cnt_shift == 0:
            c2[d, :n] = cnt_r2[lo:hi]
        # Rebased direct directory over [d*S, (d+1)*S): row offsets into
        # this shard's slice.
        counts = np.bincount((ks[lo:hi] - np.uint32(d * S)).astype(np.int64),
                             minlength=S).astype(np.int32)
        bo[d, 1:] = np.cumsum(counts, dtype=np.int32)

    L = int(index.ref_len)
    capr = 16
    while capr < L:
        capr *= 2
    ref = np.zeros((2, capr), dtype=np.uint8)
    ref[0, :L] = np.frombuffer(index.ref_fwd_seq.encode("latin1"),
                               dtype=np.uint8)
    ref[1, :L] = np.frombuffer(index.ref_rev_seq.encode("latin1"),
                               dtype=np.uint8)
    return DeviceIndex(
        key_hash=jnp.asarray(kh), key_pos=jnp.asarray(kp),
        cnt_fr=jnp.asarray(cf), cnt_r2=jnp.asarray(c2),
        bucket_off=jnp.asarray(bo),
        ref_bytes=jnp.asarray(ref), ref_len=jnp.int32(L),
        shift=0, bsearch_steps=0, cnt_shift=cnt_shift, shard_range=S)


def _host_combined_table(index):
    """Host-side combined sorted table + packed counts (the front half of
    device_index_from_host, shared with the sharded packer)."""
    import numpy as np

    fh = index.fwd.hash_sorted.astype(np.uint32)
    rh = index.rev.hash_sorted.astype(np.uint32)
    fp = index.fwd.pos_sorted.astype(np.int32)
    rp = index.rev.pos_sorted.astype(np.int32)
    U = len(fh) + len(rh)
    rev_slots = np.searchsorted(fh, rh, side="right") + np.arange(
        len(rh), dtype=np.int64)
    is_rev = np.zeros(U, dtype=bool)
    is_rev[rev_slots] = True
    ks = np.empty(U, np.uint32)
    ps = np.empty(U, np.int32)
    ks[rev_slots] = rh
    ps[rev_slots] = rp
    ks[~is_rev] = fh
    ps[~is_rev] = fp
    ss = is_rev.astype(np.uint8)
    starts = np.flatnonzero(np.concatenate([[True], ks[1:] != ks[:-1]])) \
        if U else np.zeros((0,), np.int64)
    ends = np.append(starts[1:], U)
    cum_s = np.concatenate([[0], np.cumsum(ss, dtype=np.int64)])
    rev_in = (cum_s[ends] - cum_s[starts]).astype(np.int32)
    cnt_f = np.zeros(max(U, 1), np.int64)
    cnt_r = np.zeros(max(U, 1), np.int64)
    cnt_f[starts] = (ends - starts) - rev_in
    cnt_r[starts] = rev_in
    bits_f = max(1, int(cnt_f.max()).bit_length()) if U else 1
    bits_r = max(1, int(cnt_r.max()).bit_length()) if U else 1
    if bits_f + bits_r <= 32:
        cnt_shift = 16 if (bits_f <= 16 and bits_r <= 16) else bits_f
        cnt_fr = (cnt_f | (cnt_r << cnt_shift)).astype(np.uint32)[:U]
        cnt_r2 = np.zeros(1, np.int32)
    else:
        cnt_shift = 0
        cnt_fr = cnt_f.astype(np.uint32)[:U]
        cnt_r2 = cnt_r.astype(np.int32)[:U]
    return ks, ps, cnt_fr, cnt_r2, cnt_shift


@functools.partial(jax.jit, static_argnames=("bb", "shift"))
def _bucket_directory(key_hash: jax.Array, n_real: jax.Array,
                      *, bb: int, shift: int):
    """(2^bb + 1,) int32 bucket offsets + the largest bucket size.

    bucket_off[b] = index of the first table entry whose top bb hash bits
    are >= b (identical to searchsorted over the bucket edges).  Sentinel
    pads (slots >= n_real) are excluded so bucket_off[2^bb] == n_real and
    the max-bucket estimate stays tight.
    """
    lanes = jnp.arange(key_hash.shape[0], dtype=jnp.int32)
    valid = lanes < n_real
    b = jax.lax.shift_right_logical(
        key_hash, jnp.uint32(shift)).astype(jnp.int32)
    counts = jnp.zeros((1 << bb,), jnp.int32).at[
        jnp.where(valid, b, 0)].add(valid.astype(jnp.int32))
    bo = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                          jnp.cumsum(counts, dtype=jnp.int32)])
    return bo, jnp.max(counts)


def _extract_windows(src: jax.Array, begin: jax.Array, cap: int) -> jax.Array:
    """(B, cap) contiguous windows src[b, begin[b] : begin[b]+cap].

    One sliced lax.gather: contiguous row slices cost ~0.2 ms per 256x8k
    batch where the elementwise take_along_axis formulation lowered to an
    element-serial gather (~20 ms).  The source is zero-padded by cap so a
    window overrunning the row end reads zeros (lanes beyond the region
    length are masked downstream either way)."""
    B, W = src.shape
    src_p = jnp.pad(src, ((0, 0), (0, cap)))
    starts = jnp.stack([jnp.arange(B, dtype=jnp.int32),
                        jnp.clip(begin, 0, W)], axis=1)
    return jax.lax.gather(
        src_p, starts,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(0,),
            start_index_map=(0, 1)),
        slice_sizes=(1, cap), mode="clip")


def _extract_flat_windows(src: jax.Array, begin: jax.Array,
                          cap: int) -> jax.Array:
    """(B, cap) contiguous windows src[begin[b] : begin[b]+cap] from a 1-D
    source (sliced gather; see _extract_windows).  The source is zero-padded
    by cap so a window whose END overruns the source reads zeros WITHOUT
    shifting its start (a start clamped to n-cap would fill the window's
    valid lanes with bytes from before `begin`, silently corrupting scores
    on reads whose region ends near the padded reference edge)."""
    n = src.shape[0]
    src_p = jnp.pad(src, (0, cap))
    return jax.lax.gather(
        src_p, jnp.clip(begin, 0, n)[:, None],
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,), collapsed_slice_dims=(),
            start_index_map=(0,)),
        slice_sizes=(cap,), mode="clip")


def _map_core(reads, lens, index, *, k, w, budget, region_cap,
              oob_end_windows, shard_axis=None):
    """Shared front half of the fused step: minimize -> match -> chain ->
    strand select -> region extraction.  Returns the per-read mapping
    coordinates plus the gathered (q_win, t_win, q_len, t_len) alignment
    regions.  ``shard_axis`` (inside shard_map only) switches the lookup
    to the hash-range-sharded protocol."""
    B, L = reads.shape
    mres = mz.minimize_batch(reads, lens, k, w,
                             oob_end_windows=oob_end_windows)

    # ~2/(w+1) of window slots survive dedup; pack them left so every
    # lookup round below runs at the compacted width.  The cap follows the
    # EXPECTED survivor count (+1 window of slack) rather than the full
    # match budget - probes/scatters at budget width ran ~33% idle lanes
    # (match was the fused step's largest stage).  Overflowing reads are
    # flagged (compact_queries) and the host retry's doubled budget takes
    # over via the budget//2 term, so truncation is never silent.
    expect = -(-2 * L // ((w + 1) * 128)) * 128 + 128
    keep_cap = min(mres.hashes.shape[1], budget, max(expect, budget // 2))
    q_hash, q_pos, q_keep, q_over = match_ops.compact_queries(
        mres.hashes, mres.pos, mres.dedup_keep, keep_cap)
    if shard_axis is not None and index.shard_range:
        # shard_map delivers this device's hash-range slice with a leading
        # singleton axis; squeeze it.
        sq = (lambda a: a[0]) if index.key_hash.ndim == 2 else (lambda a: a)
        got_f, got_r = match_ops.find_matches_combined_sharded(
            q_hash, q_pos, q_keep,
            sq(index.key_hash), sq(index.key_pos), sq(index.cnt_fr),
            sq(index.cnt_r2), sq(index.bucket_off),
            index.shard_range, budget, index.cnt_shift, shard_axis)
    else:
        got_f, got_r = match_ops.find_matches_combined(
            q_hash, q_pos, q_keep,
            index.key_hash, index.key_pos, index.cnt_fr, index.cnt_r2,
            index.bucket_off, index.shift, index.bsearch_steps, budget,
            index.cnt_shift)
    # One chain call over both strands' rows: one sequential loop of
    # (2B, N) steps instead of two loops of (B, N) steps.
    both = chain_ops.lis_chain(
        jnp.concatenate([got_f.f_pos, got_r.f_pos], axis=0),
        jnp.concatenate([got_f.r_pos, got_r.r_pos], axis=0),
        jnp.concatenate([got_f.count, got_r.count], axis=0))
    cf = jax.tree.map(lambda a: a[:B], both)
    cr = jax.tree.map(lambda a: a[B:], both)

    use_fwd = cf.length >= cr.length          # ties forward (quirk #8)
    mapped = jnp.where(use_fwd, cf.length, cr.length) > 0
    overflow = got_f.overflow | got_r.overflow | q_over
    need = jnp.maximum(got_f.total, got_r.total)

    q_begin = jnp.where(use_fwd, cf.q_start, cr.q_start) - 1
    q_end = jnp.where(use_fwd, cf.q_end, cr.q_end) + k - 2
    t_begin = jnp.where(use_fwd, cf.t_start, cr.t_start) - 1
    t_end = jnp.where(use_fwd, cf.t_end, cr.t_end) + k - 2

    q_len = jnp.where(mapped, q_end - q_begin + 1, 0)
    t_len = jnp.where(mapped, t_end - t_begin + 1, 0)
    # Query regions are chain-bounded within the read, so the q window cap is
    # the read width L exactly; only target regions (which may span indels)
    # need the larger region_cap.  Halving the wavefront's lane count nearly
    # halves the alignment cost.
    region_over = t_len > region_cap
    overflow = overflow | region_over
    q_len = jnp.minimum(q_len, L)
    t_len = jnp.minimum(t_len, region_cap)

    q_win = _extract_windows(reads, jnp.maximum(q_begin, 0), L)
    strand_row = jnp.where(use_fwd, 0, 1)
    ref_flat = index.ref_bytes.reshape(-1)
    ref_pad = index.ref_bytes.shape[-1]
    t_base = strand_row * ref_pad + jnp.maximum(t_begin, 0)
    t_win = _extract_flat_windows(ref_flat, t_base, region_cap)

    return (mapped, use_fwd, q_begin, q_end, t_begin, t_end, overflow,
            q_win, t_win, q_len, t_len, need)


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "mode", "budget", "region_cap",
                                    "oob_end_windows", "band",
                                    "shard_axis", "dash_free"))
def map_step(reads: jax.Array, lens: jax.Array, index: DeviceIndex,
             match: jax.Array, mismatch: jax.Array, gap: jax.Array,
             *, k: int, w: int, mode: int,
             budget: int = 512, region_cap: int = 0,
             oob_end_windows: bool = False,
             band: int = 0, shard_axis=None,
             dash_free: bool = False) -> MapOut:
    """Map a read batch end-to-end on device (score-only).

    Args:
      reads: (B, L) uint8 right-padded read bytes.
      lens:  (B,) int32.
      index: replicated DeviceIndex.
      k, w, mode: static mapper parameters.
      match/mismatch/gap: int32 scoring scalars (traced).
      budget: static per-read match budget (overflow flagged for host retry).
      region_cap: static max alignment-region length; 0 means the read
        width - regions beyond it are clamped (flagged via overflow as well).
      band: static banded-alignment width (0 = full wavefront).  Banded
        scores carry an exactness certificate (ops/band.certify);
        uncertified reads are flagged ``inexact``
        and the host realigns them at the band their own lower-bound
        score proves certifiable (pipeline/mapper._realign_bucket), so
        emitted results are ALWAYS exact.
    """
    if region_cap == 0:
        region_cap = reads.shape[1]
    (mapped, use_fwd, q_begin, q_end, t_begin, t_end, overflow,
     q_win, t_win, q_len, t_len, need) = _map_core(
        reads, lens, index, k=k, w=w, budget=budget, region_cap=region_cap,
        oob_end_windows=oob_end_windows, shard_axis=shard_axis)

    # Banded path: certificate misses surface as ``inexact`` and the host
    # reruns them through the realign-only pass at the band their
    # lower-bound score proves (the -c path's recovery), instead of a
    # whole-batch full-matrix pass for a few outliers.  band == 0 (banding
    # disabled, e.g. gap >= 0 configs where no certificate exists) runs the
    # full-matrix DP.
    inexact = jnp.zeros_like(mapped)
    if band:
        bout = band_ops.fill_banded(q_win, q_len, t_win, t_len,
                                    match, mismatch, gap, band=band,
                                    mode=mode, dash_free=dash_free)
        certified = band_ops.certify(bout.score, q_win, q_len, t_win, t_len,
                                     match, mismatch, gap, band, mode=mode)
        score = bout.score
        inexact = mapped & ~certified
    else:
        score = al.align_batch(q_win, q_len, t_win, t_len, mode,
                               match, mismatch, gap).score

    return MapOut(mapped=mapped & ~overflow, is_fwd=use_fwd,
                  q_begin=q_begin, q_end=q_end,
                  t_begin=t_begin, t_end=t_end,
                  score=score, overflow=overflow, need=need,
                  inexact=inexact)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CigarOut:
    """map_step_cigar output: MapOut plus the traceback walk.

    codes: (steps/4, B) uint8 op codes PACKED 4-per-byte (ops/trace.py
    pack_codes; unpack with unpack_codes_np) in goal->origin order - the
    host only run-length encodes them (utils/cigar.py).
    q_len/t_len: alignment-region lengths (the RLE needs them for the
    semiGlobal corner pad).  certified: the banded traceback is provably
    byte-identical to the full DP's; the host re-routes uncertified reads
    (rare: chains drifting > band/2 off-diagonal) through the full-matrix
    host path.
    """

    base: MapOut
    codes: jax.Array
    goal_i: jax.Array
    goal_j: jax.Array
    q_len: jax.Array
    t_len: jax.Array
    certified: jax.Array


@functools.partial(jax.jit,
                   static_argnames=("k", "w", "mode", "budget", "region_cap",
                                    "oob_end_windows", "band",
                                    "shard_axis", "dash_free"))
def map_step_cigar(reads: jax.Array, lens: jax.Array, index: DeviceIndex,
                   match: jax.Array, mismatch: jax.Array, gap: jax.Array,
                   *, k: int, w: int, mode: int,
                   budget: int = 512, region_cap: int = 0,
                   oob_end_windows: bool = False,
                   band: int = 256, shard_axis=None,
                   dash_free: bool = False) -> CigarOut:
    """Fused -c step: map_step plus banded-parents alignment and the
    on-device traceback walk, for ALL THREE alignment modes (local /
    semiGlobal goal cells come from the banded kernel's in-band argmax /
    rim tracking; their exactness is covered by the mode-aware certificate,
    ops/band.certify).

    The whole -c pipeline stays on device: region gather, banded parent
    fill (2-bit packed, ops/band.fill_banded), lockstep batch walk
    (ops/trace.py).  Only the (steps, B) op-code tensor crosses to the host,
    which run-length encodes it - no per-read Python strings anywhere
    (replaces the reference's per-read traceback + RLE,
    team_alignment.cpp:122-161).
    """
    if region_cap == 0:
        region_cap = reads.shape[1]
    (mapped, use_fwd, q_begin, q_end, t_begin, t_end, overflow,
     q_win, t_win, q_len, t_len, need) = _map_core(
        reads, lens, index, k=k, w=w, budget=budget, region_cap=region_cap,
        oob_end_windows=oob_end_windows, shard_axis=shard_axis)

    from bioinfo1_tpu.ops import trace as tr
    out = band_ops.fill_banded(q_win, q_len, t_win, t_len,
                               match, mismatch, gap, band=band,
                               want_parents=True, mode=mode,
                               dash_free=dash_free)
    certified = band_ops.certify(out.score, q_win, q_len, t_win, t_len,
                                 match, mismatch, gap, band, strict=True,
                                 mode=mode)
    codes = tr.pack_codes(tr.walk_parents(
        out.parents, out.goal_i, out.goal_j, out.score,
        q_win, t_win, match, mismatch, gap, mode=mode,
        band=band_ops.band_width(band)))
    base = MapOut(mapped=mapped & ~overflow, is_fwd=use_fwd,
                  q_begin=q_begin, q_end=q_end,
                  t_begin=t_begin, t_end=t_end,
                  score=out.score, overflow=overflow, need=need,
                  inexact=jnp.zeros_like(mapped))
    return CigarOut(base=base, codes=codes,
                    goal_i=out.goal_i, goal_j=out.goal_j,
                    q_len=q_len, t_len=t_len, certified=certified)


def kernel_in_lowered_steps(mode: int = 0) -> tuple:
    """(map_step, map_step_cigar): does each step, lowered for the default
    device, call the CUDA band-fill kernel?  Lowers a small synthetic batch
    against a small index; compiles nothing."""
    import numpy as np
    from bioinfo1_tpu.index import builder
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(0)
    genome = sim.random_genome(4096, rng)
    index = builder.build_index(genome.tobytes().decode("latin1"), 15, 5,
                                0.001)
    didx = device_index_from_host(index)
    reads = jnp.asarray(genome[:8 * 512].reshape(8, 512))
    lens = jnp.full((8,), 512, jnp.int32)
    args = (reads, lens, didx, jnp.int32(1), jnp.int32(-1), jnp.int32(-1))
    kw = dict(k=15, w=5, mode=mode, budget=256, region_cap=1024, band=128)
    found = []
    for step in (map_step, map_step_cigar):
        text = step.lower(*args, **kw).as_text()
        found.append(band_ops.KERNEL_TARGET in text)
    return tuple(found)
