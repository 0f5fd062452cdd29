"""End-to-end batched read mapping pipeline.

Re-design of the reference's per-read OpenMP loop
(team_mapper.cpp:596-698 FASTA / 710-789 FASTQ): instead of one thread per
read walking hash maps and filling a heap DP matrix, whole read batches move
through fixed-shape device stages:

    pack -> minimize_batch -> find_matches (fwd+rev) -> lis_chain (fwd+rev)
         -> strand select + region extract -> banded fill -> [traceback]
         -> PAF rows (host)

Shapes are controlled by two levers:
  * reads are length-bucketed so each jit specialization serves a band of
    read lengths (padding waste is bounded by the bucket growth factor),
  * per-read match budgets start small and the rare overflowing reads are
    retried with a doubled budget (exact - never truncates silently).

Output order is input order (deterministic; documented delta from the
reference's nondeterministic ``omp critical`` interleaving).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np

from bioinfo1_tpu.index.builder import IndexArrays
from bioinfo1_tpu.ops import align as al
from bioinfo1_tpu.ops import band as band_ops
from bioinfo1_tpu.ops import chain as chain_ops
from bioinfo1_tpu.ops import match as match_ops
from bioinfo1_tpu.ops import minimizer as mz
from bioinfo1_tpu.utils import cigar as cg


@dataclasses.dataclass
class MapperConfig:
    """Mirror of the reference CLI knobs (team_mapper.cpp:329-334 defaults)."""

    align_type: str = "global"
    match: int = 1
    mismatch: int = -1
    gap: int = -1
    k: int = 15
    w: int = 5
    f: float = 0.001
    output_cigar: bool = False
    sam_cigar: bool = False          # extension: emit SAM-convention CIGARs
    # bug-compat switches (False = fixed semantics; see SURVEY.md 2.3 item 11)
    banned_rev_from_fwd: bool = False
    fasta_match_nesting: bool = False
    local_target_begin_end: bool = False
    threshold_from_rev_unique: bool = False
    exact_ties: bool = False
    oob_end_windows: bool = False
    # batching knobs
    batch_size: int = 512
    initial_match_budget: int = 512
    bucket_growth: float = 1.5
    # device parallelism: 0 = all local devices (largest pow-2 prefix),
    # 1 = force single-device, N = cap the mesh at N devices
    devices: int = 0


@dataclasses.dataclass
class MapperCounters:
    """Pipeline observability (VERDICT r02 item 5): DP problem-size cells
    (for GCUPS), banded-certificate hit rate, and retry-ladder counts.
    The reference has no counters at all (SURVEY.md section 5)."""

    reads: int = 0
    mapped: int = 0
    dp_cells: float = 0.0          # sum of region (n+1)*(m+1) for mapped reads
    batches: int = 0
    cert_total: int = 0            # mapped reads through a certified path
    cert_hits: int = 0
    budget_retries: int = 0        # match-budget overflow reruns
    host_fallbacks: int = 0        # certificate misses re-routed to host
    band_retries: int = 0          # fused reruns at a doubled band
    faults: int = 0                # batches that raised and were isolated
    # Itemized wall-clock budget (VERDICT r03 item 9): where batch time
    # goes, summed over worker threads (overlap means these can exceed the
    # pipeline's wall time).
    t_fused_s: float = 0.0         # fused device dispatch + fetch
    t_host_s: float = 0.0          # staged host-path batches
    t_decode_s: float = 0.0        # native/python CIGAR decode
    t_format_s: float = 0.0        # stats + PAF serialization

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if self.cert_total:
            d["cert_hit_rate"] = round(self.cert_hits / self.cert_total, 4)
        for k in ("t_fused_s", "t_host_s", "t_decode_s", "t_format_s"):
            d[k] = round(d[k], 3)
        return d


@dataclasses.dataclass
class ReadMapping:
    """One read's mapping result (None fields when the read had no chain)."""

    mapped: bool
    is_fwd: bool = True
    q_begin: int = 0
    q_end: int = 0            # inclusive
    t_begin: int = 0          # in strand coordinates (RC coords for rev)
    t_end: int = 0            # inclusive
    score: int = 0
    cigar: Optional[str] = None
    target_begin: Optional[int] = None


# Shares of one device's memory (its ``bytes_limit``, what the JAX
# allocator may use) given to the transient -c parent tensor of one batch,
# to all batches in flight together, and to a replicated index before it is
# hash-range sharded instead.  The index and the in-flight batches must fit
# side by side, so the two shares add up to 3/4.
PARENT_SHARE = 1 / 8
INFLIGHT_SHARE = 3 / 8
INDEX_SHARE = 3 / 8


def _device_budget(share: float, cpu_bytes: float) -> float:
    """``share`` of the first device's memory limit.  The CPU test backend
    reports no memory stats; it gets the fixed ``cpu_bytes`` instead."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return share * limit if limit else cpu_bytes


def _pow2_at_least(x: int, floor: int = 8) -> int:
    v = floor
    while v < x:
        v *= 2
    return v


def _bucket_cap(ln: int, floor: int = 16) -> int:
    """Canonical length-bucket cap: powers of two interleaved with
    3/4-points (…, 1024, 1536, 2048, 3072, 4096, 6144, 8192, …) above 512.

    The wavefront cost is linear in the PADDED length, so pure pow-2
    buckets waste up to 2x on uniformly distributed read lengths (a
    4.1 kb read sweeping an 8.2 kb pad); the 1.5-step ladder caps the
    waste at 1.5x for ~1.5x the jit keys.  3/4 of a pow-2 >= 512 is a
    multiple of 128, so the 128-lane band rounding still holds."""
    p = _pow2_at_least(max(ln, floor), 16)
    if p >= 512 and 3 * p // 4 >= ln:
        return 3 * p // 4
    return p


def _region_cap(cap: int) -> int:
    """Target-region width for a length bucket: ~2x the query cap on the
    same 1.5-step ladder as _bucket_cap.  The old pow-2 round-up charged
    the 3/4-point buckets (1536/3072/6144) a ~33% oversized target window
    (6144 -> 16384) through region gather, certify and m_eff."""
    return _bucket_cap(2 * cap, 16)


def _batch_cap(b: int, floor: int) -> int:
    """Canonical BATCH size: powers of two interleaved with 3/4-points
    where those stay 64-divisible (192, 384, 768, ...).  Every per-batch
    cost - fills, walks, match tables, the -c codes fetch - scales with
    the PADDED batch, and sub-flush-size bucket flushes (mixed-length
    tails, end-of-stream) padded to the next pow-2 ran up to 33% idle
    rows (a 342-read repeat flush padded to 512).  64-divisibility keeps
    every pow-2 mesh size (up to 64 devices) dividing the batch."""
    p = _pow2_at_least(b, floor)
    q = 3 * p // 4
    if q >= b and q % 64 == 0 and q % max(floor, 1) == 0:
        return q
    return p


def _pack_reads(seqs: Sequence[str], min_len: int,
                canonical: bool = True,
                min_batch: int = 8,
                len_to: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Pack strings into a right-padded uint8 batch.

    ``canonical`` rounds both dims up to canonical sizes so jit
    specializations recur across batches (and across runs, via the
    persistent compile cache) instead of exploding one compile per
    data-dependent shape.  ``min_batch`` raises the batch floor (a pow-2
    mesh size always divides the padded batch).  ``len_to`` pins the
    length dim to the caller's bucket cap (the 1.5-step _bucket_cap
    ladder) instead of the pow-2 round-up.
    """
    L = max(max((len(s) for s in seqs), default=1), min_len)
    B = len(seqs)
    if canonical:
        L = max(L, len_to) if len_to >= L else _pow2_at_least(L, 16)
        B = _batch_cap(B, min_batch)
    arr = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros((B,), dtype=np.int32)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("latin1"), dtype=np.uint8)
        arr[i, : len(b)] = b
        lens[i] = len(b)
    return arr, lens


def _bucket_indices(lengths: Sequence[int], growth: float,
                    floor: int) -> List[List[int]]:
    """Group read indices into power-of-two length buckets.

    Pow-2 (not data-dependent) bucket caps keep the padded shapes canonical;
    padding waste is bounded at 2x and typically far less after packing.
    """
    buckets_by_cap: dict = {}
    for i, ln in enumerate(lengths):
        cap = _bucket_cap(ln, floor)
        buckets_by_cap.setdefault(cap, []).append(i)
    return [buckets_by_cap[c] for c in sorted(buckets_by_cap)]


def _needed_band_arr(ql, tl, score, match: int, mismatch: int, gap: int,
                     mode: int, strict: bool):
    """Per-read minimal band W certifying the banded result, solved from
    ops/band.certify's bounds (strict adds the one-point margin the
    traceback guarantee needs).  None when no finite band certifies
    (global with gap >= 0)."""
    maxsub = max(match, mismatch, 0)
    diff = tl - ql
    eps = 1 if strict else 0
    if mode == 0:
        if gap >= 0:
            return None
        need2 = (-(-(maxsub * np.minimum(ql, tl) - score + eps) // (-gap))
                 + np.abs(diff))
        # certify's goal_in_band term additionally needs W >= |tl-ql| + 2
        # (the goal cell's diagonal offset must lie inside the band) -
        # without it a high-scoring length-skewed region under-sizes the
        # band to one that provably cannot certify (ADVICE r03).
        return np.maximum(need2 // 2 + 2, np.abs(diff) + 2)
    if maxsub <= 0:
        return np.zeros_like(ql)
    F = (score - eps) // maxsub
    w1 = np.where(ql <= F, 0, tl + 1 - F)
    w2 = np.where(tl <= F, 0, ql + 1 - F)
    return np.maximum(np.maximum(w1, w2), 0)


def _decode_cigars(packed_codes, idxs, goal_i, goal_j, q_len, t_len,
                   cfg: "MapperConfig"):
    """(cigars, target_begins) for the selected reads, decoded from the
    PACKED device-walk codes - natively (native/cigar.cpp, one C++ pass
    over the packed bytes) with utils.cigar.cigar_from_codes as the
    executable-spec fallback.  The per-read numpy+f-string RLE was the -c
    pipeline's largest host cost (~1.4 ms/read at 8 kb)."""
    from bioinfo1_tpu import native
    idxs = np.asarray(idxs, dtype=np.int32)
    gi = np.asarray(goal_i)[idxs]
    gj = np.asarray(goal_j)[idxs]
    ql = np.asarray(q_len)[idxs]
    tl = np.asarray(t_len)[idxs]
    nat = native.cigar_rle_batch(
        packed_codes, idxs, gi, gj, ql, tl, cfg.align_type,
        sam_convention=cfg.sam_cigar,
        local_target_begin_end=cfg.local_target_begin_end)
    if nat is not None:
        return nat
    from bioinfo1_tpu.ops.trace import unpack_codes_np
    codes = unpack_codes_np(packed_codes)
    cigs, tbs = [], []
    for loc, i in enumerate(idxs):
        c, tb = cg.cigar_from_codes(
            codes[:, i], cfg.align_type, int(gi[loc]), int(gj[loc]),
            int(ql[loc]), int(tl[loc]), sam_convention=cfg.sam_cigar,
            local_target_begin_end=cfg.local_target_begin_end)
        cigs.append(c)
        tbs.append(tb)
    return cigs, tbs


def _chains_for_strand(mres, idx_strand, budget: int):
    got = match_ops.find_matches(
        mres.hashes, mres.pos, mres.dedup_keep,
        idx_strand.hash_sorted, idx_strand.pos_sorted, budget)
    return got, chain_ops.lis_chain(got.f_pos, got.r_pos, got.count)


def _map_bucket(seqs: Sequence[str], index: IndexArrays, cfg: MapperConfig,
                budget: int, band_hint: int = 0,
                ) -> Tuple[List[ReadMapping], List[int]]:
    """Map one length bucket; returns results plus indices needing a bigger
    match budget (overflow retry path).  ``band_hint`` seeds the banded -c
    band (callers pass the certifying width their own scores prove, so the
    first banded pass certifies instead of laddering)."""
    k, w = index.k, index.w
    arr, lens = _pack_reads(seqs, k + w - 1)
    mres = mz.minimize_batch(arr, lens, k, w,
                             oob_end_windows=cfg.oob_end_windows)

    got_f, chain_f = _chains_for_strand(mres, index.fwd, budget)
    if cfg.fasta_match_nesting:
        # Bug-compat: rev lookups gated on a fwd-index hit per minimizer
        # (team_mapper.cpp:629-638).  Mask the dedup_keep with fwd presence.
        present = match_ops.hash_present(index.fwd.hash_sorted, mres.hashes)
        gated_keep = jax.device_get(mres.dedup_keep) & jax.device_get(present)
        got_r = match_ops.find_matches(
            mres.hashes, mres.pos, gated_keep,
            index.rev.hash_sorted, index.rev.pos_sorted, budget)
        chain_r = chain_ops.lis_chain(got_r.f_pos, got_r.r_pos, got_r.count)
    else:
        got_r, chain_r = _chains_for_strand(mres, index.rev, budget)

    overflow = jax.device_get(got_f.overflow) | jax.device_get(got_r.overflow)
    cf = jax.device_get(chain_f)
    cr = jax.device_get(chain_r)
    len_f, len_r = cf.length, cr.length

    # Strand selection: longer chain wins, ties forward (team_mapper.cpp:644-648).
    use_fwd = len_f >= len_r
    have = np.where(use_fwd, len_f, len_r) > 0

    q_start = np.where(use_fwd, cf.q_start, cr.q_start)
    q_end_m = np.where(use_fwd, cf.q_end, cr.q_end)
    t_start = np.where(use_fwd, cf.t_start, cr.t_start)
    t_end_m = np.where(use_fwd, cf.t_end, cr.t_end)

    # Region extraction (team_mapper.cpp:653-656): 1-based minimizer pos ->
    # 0-based inclusive [begin, end] windows extended by k.
    q_begin = q_start - 1
    q_end = q_end_m + k - 2
    t_begin = t_start - 1
    t_end = t_end_m + k - 2

    results: List[ReadMapping] = [ReadMapping(mapped=False) for _ in seqs]
    retry: List[int] = []

    # Collect alignment jobs (skip unmapped reads and overflowed reads).
    jobs = []
    for i in range(len(seqs)):
        if overflow[i]:
            retry.append(i)
            continue
        if not have[i]:
            continue
        jobs.append(i)

    if jobs:
        ref_f = index.ref_fwd_seq
        ref_r = index.ref_rev_seq
        qs, ts = [], []
        for i in jobs:
            # OOB chain coordinates (bug #4) read past the end; the
            # reference's pointer arithmetic picks up the c_str NUL.
            q = seqs[i][q_begin[i]: q_end[i] + 1]
            q += "\0" * (q_end[i] - q_begin[i] + 1 - len(q))
            qs.append(q)
            src = ref_f if use_fwd[i] else ref_r
            t = src[t_begin[i]: t_end[i] + 1]
            t += "\0" * (t_end[i] - t_begin[i] + 1 - len(t))
            ts.append(t)
        qa, ql = _pack_reads(qs, 1)
        ta, tl = _pack_reads(ts, 1)
        # Long global regions take the banded parents path: the parent
        # tensor shrinks by (n+1)/band (the -c memory/transfer hot spot) and
        # the strict certificate guarantees byte-identical tracebacks;
        # certificate misses re-run through the full kernel below.
        mode_i = al.MODE_BY_NAME[cfg.align_type]
        w_whole0 = max(qa.shape[1], ta.shape[1] + 2)
        band = 256
        if band_hint:
            band = min(_pow2_at_least(max(band_hint, 256), 256),
                       -(-w_whole0 // 128) * 128)
        use_band = cfg.output_cigar and qa.shape[1] > 512
        banded = {}
        # The certificate machinery only applies under the modes' gap-sign
        # preconditions and (global) without literal '-' bytes.
        dash_free = not ((qa == ord("-")).any() or (ta == ord("-")).any())
        cert_ok = ((cfg.gap < 0) if mode_i == 0 else (cfg.gap <= 0)) and not (
            mode_i == 0 and not dash_free)
        if use_band and cert_ok:

            def run_banded(W):
                return band_ops.fill_banded(
                    qa, ql, ta, tl, cfg.match, cfg.mismatch, cfg.gap,
                    band=W, want_parents=True, mode=mode_i,
                    dash_free=bool(dash_free))

            def run_cert(bout, W):
                return jax.device_get(band_ops.certify(
                    bout.score, qa, ql, ta, tl,
                    np.int32(cfg.match), np.int32(cfg.mismatch),
                    np.int32(cfg.gap), W, strict=True, mode=mode_i))

            bout = run_banded(band)
            cert = run_cert(bout, band)
            if not cert.all():
                # Retry once at the band the misses provably certify at,
                # solved from the first pass's scores (exact lower bounds:
                # a wider band only improves them, so score > bound(W2)
                # transfers).  This replaces the full-matrix fallback that
                # cost seconds per miss (lax wavefront, one step per
                # anti-diagonal) and O(n*m/16) parent HBM.
                w_need = _needed_band_arr(
                    ql.astype(np.int64), np.minimum(tl, ta.shape[1]),
                    jax.device_get(bout.score), cfg.match, cfg.mismatch,
                    cfg.gap, mode_i, strict=True)
                w_whole = max(int(ql.max()), int(tl.max()) + 2)
                W2 = int(np.max(w_need[~cert]))
                # Pow-2 rounding bounds the jit-key count; whole-matrix
                # width caps it (certify's `whole` term then holds).
                W2 = min(_pow2_at_least(max(W2, 2 * band), 512),
                         -(-w_whole // 128) * 128)
                bout = run_banded(W2)
                cert = run_cert(bout, W2)
                band = W2
            if cert.all():
                out = bout
                banded = {b: True for b in range(len(jobs))}
            else:  # unreachable for finite w_need; safety net
                out = al.align_batch(
                    qa, ql, ta, tl, mode_i,
                    cfg.match, cfg.mismatch, cfg.gap, want_parents=True)
                banded = {}
        else:
            out = al.align_batch(
                qa, ql, ta, tl, al.MODE_BY_NAME[cfg.align_type],
                cfg.match, cfg.mismatch, cfg.gap,
                want_parents=cfg.output_cigar)
        scores = jax.device_get(out.score)
        goal_i = jax.device_get(out.goal_i)
        goal_j = jax.device_get(out.goal_j)
        cig_pairs = None
        if cfg.output_cigar:
            # Device traceback walk: the packed parents stay on the device;
            # only a packed (steps/4, B) uint8 op-code tensor crosses to the
            # host (ops/trace.py), decoded by one native RLE pass - no
            # 10^2 MB parents fetch, no per-base Python.
            from bioinfo1_tpu.ops import trace as tr
            walk_band = band_ops.band_width(band) if banded else 0
            packed = jax.device_get(tr.pack_codes(
                tr.walk_parents(
                    out.parents, out.goal_i, out.goal_j, out.score,
                    qa, ta, cfg.match, cfg.mismatch, cfg.gap,
                    mode=al.MODE_BY_NAME[cfg.align_type], band=walk_band)))
            cigs, tbs = _decode_cigars(
                packed, list(range(len(jobs))), goal_i, goal_j,
                [len(q) for q in qs], [len(t) for t in ts], cfg)
            cig_pairs = list(zip(cigs, tbs))

        for b, i in enumerate(jobs):
            cigar = None
            target_begin = None
            if cfg.output_cigar:
                cigar, target_begin = cig_pairs[b]
            results[i] = ReadMapping(
                mapped=True, is_fwd=bool(use_fwd[i]),
                q_begin=int(q_begin[i]), q_end=int(q_end[i]),
                t_begin=int(t_begin[i]), t_end=int(t_end[i]),
                score=int(scores[b]), cigar=cigar, target_begin=target_begin)
    return results, retry


def paf_line(name: str, read_len: int, m: ReadMapping, ref_name: str,
             ref_len: int, output_cigar: bool) -> str:
    """Serialize one PAF row (team_mapper.cpp:685-698): 12 tab columns, DP
    score in the residue-matches column, literal mapq 60; rev-strand target
    coords flipped back to forward (team_mapper.cpp:689-690)."""
    if m.is_fwd:
        t_start_out, t_end_out = m.t_begin, m.t_end + 1
    else:
        t_start_out = ref_len - m.t_end - 1
        t_end_out = ref_len - m.t_begin
    fields = [
        name, str(read_len), str(m.q_begin), str(m.q_end + 1),
        "+" if m.is_fwd else "-", ref_name, str(ref_len),
        str(t_start_out), str(t_end_out),
        str(m.score), str(m.q_end - m.q_begin + 1), "60",
    ]
    if output_cigar:
        fields.append(f"cg:Z:{m.cigar}")
    return "\t".join(fields)


class Mapper:
    """Reusable mapping engine bound to one reference index."""

    def __init__(self, reference_records: Sequence[Tuple[str, str]],
                 cfg: MapperConfig, load_index: Optional[str] = None):
        from bioinfo1_tpu.index import builder
        self.cfg = cfg
        # Only referenceSequence.front() is used - later records are ignored
        # entirely (quirk #10, team_mapper.cpp:415).
        self.ref_name, reference = reference_records[0]
        if load_index:
            self.index = builder.load_index(load_index)
            self.index.ref_fwd_seq = reference
            self.index.ref_rev_seq = builder.reverse_complement_str(reference)
        else:
            self.index = builder.build_index(
                reference, cfg.k, cfg.w, cfg.f,
                banned_rev_from_fwd=cfg.banned_rev_from_fwd,
                threshold_from_rev_unique=cfg.threshold_from_rev_unique,
                exact_ties=cfg.exact_ties,
                oob_end_windows=cfg.oob_end_windows)
        import threading
        self.ref_len = len(reference)
        # One O(genome) host scan enabling the kernels' dash-free
        # specialization (the reference's literal-'-' free-gap rule,
        # team_alignment.cpp:25-28, costs 4 VPU ops per DP cell and real
        # inputs never contain '-').  Both strands: the revcomp table maps
        # non-base bytes to themselves, but check rather than assume.
        self._ref_dash_free = ("-" not in self.index.ref_fwd_seq
                               and "-" not in self.index.ref_rev_seq)
        self._dash_free_sticky = True
        self.counters = MapperCounters()
        self._counters_lock = threading.Lock()   # map_batch runs on worker
        self._band_by_key: dict = {}     # (cap, for_cigar) -> band
        self._budget_boost: dict = {}    # cap -> pow-2 budget multiplier
        self._load_band_cache()
        self._device_index = None
        self._mesh = None
        self._mesh_resolved = False
        self._replicated_index = None
        self._sharded_steps: dict = {}

    # The fused single-jit device step (pipeline/device_map.py) serves the
    # score-only path and -c in all three modes (banded parents + on-device
    # walk, mode-aware certificate); only the FASTA match-nesting
    # bug-compat gate stages through the host pipeline instead.
    def _fast_path_ok(self) -> bool:
        return not self.cfg.fasta_match_nesting

    def _get_device_index(self):
        # Locked: map_batch runs on pipeline worker threads, and two first
        # batches racing here would build (and upload) the multi-GB device
        # index twice.
        with self._counters_lock:
            if self._device_index is None:
                from bioinfo1_tpu.pipeline import device_map as dm
                self._device_index = dm.device_index_from_host(self.index)
            return self._device_index

    def _get_mesh(self):
        """Data-parallel mesh over the local devices (None = single device).

        The product analog of the reference's OpenMP thread team
        (team_mapper.cpp:596): reads sharded over the mesh, index replicated,
        outputs gathered in input order (deterministic by construction).
        """
        with self._counters_lock:
            if not self._mesh_resolved:
                from bioinfo1_tpu.parallel import shard as ps
                self._mesh = (None if self.cfg.devices == 1
                              else ps.auto_mesh(self.cfg.devices))
                self._mesh_resolved = True
            return self._mesh

    def _index_shard_count(self, mesh) -> int:
        """How many hash-range shards the mesh index should use (0 =
        replicate).  BIOINFO1_INDEX_SHARD: 0/off forces replication, 1/on
        forces sharding, auto (default) shards when the REPLICATED lookup
        structures would exceed BIOINFO1_INDEX_BUDGET bytes per device
        (default: INDEX_SHARE of the device's memory, _device_budget - the
        E. coli-scale index replicates comfortably; a genome much beyond
        it does not fit one device)."""
        import os
        if mesh is None:
            return 0
        mode = os.environ.get("BIOINFO1_INDEX_SHARD", "auto")
        if mode in ("0", "false", "off"):
            return 0
        hash_bits = 2 * self.cfg.k
        can = hash_bits <= 30 and (1 << hash_bits) % mesh.size == 0
        if not can:
            return 0
        if mode in ("1", "true", "on"):
            return mesh.size
        # auto: estimated replicated footprint (direct-address directory +
        # combined table) vs per-device budget.
        n_entries = (len(self.index.fwd.hash_sorted)
                     + len(self.index.rev.hash_sorted))
        direct = hash_bits <= 30 and n_entries >= (1 << 20)
        est = n_entries * 12 + (4 * ((1 << hash_bits) + 1) if direct else 0)
        budget = float(os.environ.get(
            "BIOINFO1_INDEX_BUDGET", _device_budget(INDEX_SHARE, 6e9)))
        return mesh.size if est > budget else 0

    def _get_replicated_index(self, mesh):
        """Mesh-placed index: replicated per device, or hash-range sharded
        across the mesh when large (_index_shard_count)."""
        n_shards = self._index_shard_count(mesh)
        didx = None if n_shards else self._get_device_index()
        with self._counters_lock:
            if self._replicated_index is None:
                from bioinfo1_tpu.parallel import shard as ps
                if n_shards:
                    from bioinfo1_tpu.pipeline import device_map as dm
                    self._replicated_index = ps.shard_index(
                        dm.sharded_device_index_from_host(
                            self.index, n_shards), mesh)
                else:
                    self._replicated_index = ps.replicate_index(didx, mesh)
            return self._replicated_index

    def _get_sharded_step(self, mesh, key):
        with self._counters_lock:
            return self._get_sharded_step_locked(mesh, key)

    def _get_sharded_step_locked(self, mesh, key):
        if key not in self._sharded_steps:
            from bioinfo1_tpu.parallel import shard as ps
            specs = (ps._index_specs(self._replicated_index)
                     if self._replicated_index is not None
                     and self._replicated_index.shard_range else None)
            if key[0] == "cigar":
                (_, mode, budget, region_cap, band, oob, dash_free) = key
                fn = ps.sharded_map_step_cigar(
                    mesh, k=self.cfg.k, w=self.cfg.w, mode=mode,
                    budget=budget, region_cap=region_cap,
                    band=band, oob_end_windows=oob,
                    index_specs=specs, dash_free=dash_free)
            else:
                (mode, budget, region_cap, band, oob, dash_free) = key
                fn = ps.sharded_map_step(
                    mesh, k=self.cfg.k, w=self.cfg.w, mode=mode,
                    budget=budget, region_cap=region_cap,
                    band=band, oob_end_windows=oob,
                    index_specs=specs, dash_free=dash_free)
            self._sharded_steps[key] = fn
        return self._sharded_steps[key]

    def _band_cache_path(self):
        """Adaptive-band persistence (perf-only state, like the jit cache):
        a fresh process otherwise re-learns every bucket's band by paying
        full-width fallback passes first.  Keyed by the scoring/mode config
        the bands depend on.  BIOINFO1_BAND_CACHE overrides the location
        ('0' disables)."""
        import os
        import tempfile
        env = os.environ.get("BIOINFO1_BAND_CACHE")
        if env in ("0", "false"):
            return None, None
        path = env or os.path.join(tempfile.gettempdir(),
                                   "bioinfo1_tpu_bands.json")
        cfg = self.cfg
        key = (f"{cfg.align_type},{cfg.match},{cfg.mismatch},{cfg.gap},"
               f"{cfg.k},{cfg.w}")
        return path, key

    def _load_band_cache(self) -> None:
        import json
        import os
        path, key = self._band_cache_path()
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as fh:
                d = json.load(fh).get(key, {})
            for k, v in d.items():
                if k.startswith("boost,"):
                    self._budget_boost[int(k.split(",")[1])] = int(v)
                    continue
                cap_s, fc_s = k.split(",")
                self._band_by_key[(int(cap_s), fc_s == "1")] = int(v)
        except Exception:
            pass

    def _save_band_cache(self) -> None:
        import json
        import os
        path, key = self._band_cache_path()
        if not path or not (self._band_by_key or self._budget_boost):
            return
        try:
            d = {}
            if os.path.exists(path):
                with open(path) as fh:
                    d = json.load(fh)
            d.setdefault(key, {})
            for (cap, fc), band in self._band_by_key.items():
                d[key][f"{cap},{1 if fc else 0}"] = band
            for cap, boost in self._budget_boost.items():
                d[key][f"boost,{cap}"] = boost
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(d, fh)
            os.replace(tmp, path)
        except Exception:
            pass

    def _bucket_band(self, cap: int, for_cigar: bool) -> int:
        """Current band for a length bucket (adaptive; see _adapt_band)."""
        key = (cap, for_cigar)
        b = self._band_by_key.get(key)
        if b is None:
            b = 256 if (for_cigar or cap > 512) else 0
            self._band_by_key[key] = b
        return b

    def _max_fused_band(self, cap: int, batch: int) -> int:
        """Band ceiling for the fused -c ladder: the parent tensor is
        (n + m_eff) rows x batch x W/4 bytes (2 bits per band cell,
        ops/band.py), at most ~cap*batch*W bytes since m_eff <= 3*cap; keep
        it under PARENT_SHARE of device memory and never wider than the
        whole-matrix certainty threshold (W >= region_cap + 2)."""
        mem_cap = int(_device_budget(PARENT_SHARE, 4e9)
                      // max(cap * batch, 1))
        return min(_region_cap(cap) + 128,
                   max(256, (mem_cap // 128) * 128))

    def _adapt_band_score(self, cap: int, out, n_real: int) -> None:
        """Retune the score-path band from the observed scores.  A cert miss
        there costs no correctness (map_step falls back to the full kernel
        in-jit for the whole batch) but wastes the banded pass; on
        indel-rich workloads (MAP006-like) the fixed r02 band of 256 missed
        nearly always.  The fallback's scores are EXACT, so the minimal
        certifying band solves directly from ops/band.certify's
        bound: 2*(W-1) >= (maxsub*min(n,m) - score)/(-gap) + |m-n| - one
        observation converges the bucket (no doubling ladder needed here)."""
        band = self._band_by_key.get((cap, False), 0)
        cfg = self.cfg
        if not band:
            return
        mode = al.MODE_BY_NAME[cfg.align_type]
        if cfg.gap > 0 or (mode == 0 and cfg.gap == 0):
            # Certificates need gap < 0 (global) / gap <= 0 (local, semi).
            self._band_by_key[(cap, False)] = 0
            return
        W = -(-band // 128) * 128
        ql = np.minimum(out.q_end - out.q_begin + 1, cap)[:n_real]
        tl = np.minimum(out.t_end - out.t_begin + 1,
                        _region_cap(cap))[:n_real]
        score = out.score[:n_real]
        mapped = out.mapped[:n_real]
        n_mapped = int(mapped.sum())
        if not n_mapped:
            return
        w_need_arr = _needed_band_arr(ql, tl, score, cfg.match, cfg.mismatch,
                                      cfg.gap, mode, strict=False)
        whole = (ql <= W) & (tl <= W - 2)
        # A read certifies at the current W iff its needed band <= W (the
        # same solve ops/band.certify performs, inverted) or the
        # band covers its whole matrix.
        cert = whole | (w_need_arr <= W)
        w_need_arr = np.where(mapped, w_need_arr, 0)
        with self._counters_lock:
            self.counters.cert_total += n_mapped
            self.counters.cert_hits += int((mapped & cert).sum())
        if not bool((mapped & ~cert).any()):
            return
        # Size the band for the 99th-PERCENTILE mapped read, not the worst:
        # one chimera-like outlier would otherwise inflate - or, worse,
        # permanently disable - the whole bucket's band, turning every later
        # batch into a full-width pass (measured 3x on a 25k-read run).  The
        # outlier's own batch pays the in-jit full pass either way.  Clamp
        # to cap/2: beyond that banding cannot win, but outlier-free batches
        # still certify, so never drop the band back to 0.
        w99 = float(np.percentile(w_need_arr[mapped], 99))
        new = -(-int(max(w99, band)) // 128) * 128
        max_band = max(128, (cap // 2 // 128) * 128)
        self._band_by_key[(cap, False)] = min(new, max_band)

    def _realign_bucket(self, seqs: Sequence[str], hints: dict,
                        ) -> Tuple[List[ReadMapping], List[int]]:
        """Cert-missed outliers: re-run ONLY the banded-parents alignment
        and walk at the band each read's own fused score (an exact lower
        bound) proves certifiable, reusing the exact chain coordinates from
        the failed pass - the front half (minimize/match/chain) is
        deterministic, so its outputs transfer.  One light dispatch covers
        ALL missed reads across length buckets, where a full fused rerun
        would pay the whole front half plus one dispatch and fetch PER
        bucket.  Returns (results, host_retry_locs)."""
        cfg = self.cfg
        mode = al.MODE_BY_NAME[cfg.align_type]
        qs, ts = [], []
        for i in range(len(seqs)):
            _, qb, qe, tb, te, fwd, _ = hints[i]
            q = seqs[i][qb: qe + 1]
            q += "\0" * (qe - qb + 1 - len(q))
            src = self.index.ref_fwd_seq if fwd else self.index.ref_rev_seq
            t = src[tb: te + 1]
            t += "\0" * (te - tb + 1 - len(t))
            qs.append(q)
            ts.append(t)
        qa, ql = _pack_reads(qs, 1)
        ta, tl = _pack_reads(ts, 1)
        w_whole = max(qa.shape[1], ta.shape[1] + 2)
        W = min(_pow2_at_least(max(max(h[0] for h in hints.values()), 256),
                               256), -(-w_whole // 128) * 128)
        dash_free = bool(self._dash_free_sticky and self._ref_dash_free
                         and not (qa == 45).any() and not (ta == 45).any())
        from bioinfo1_tpu.ops import trace as tr
        import jax.numpy as jnp
        m_, n_, g_ = (jnp.int32(cfg.match), jnp.int32(cfg.mismatch),
                      jnp.int32(cfg.gap))
        # Score-only callers (map_step's long-read ``inexact`` route) skip
        # the parent stream and the walk entirely: certification alone
        # (non-strict - ties are fine when only the score is emitted)
        # makes the banded score exact.
        want_cigar = bool(cfg.output_cigar)
        out = band_ops.fill_banded(
            qa, ql, ta, tl, m_, n_, g_, band=W, want_parents=want_cigar,
            mode=mode, dash_free=dash_free)
        cert_d = band_ops.certify(
            out.score, qa, ql, ta, tl, np.int32(cfg.match),
            np.int32(cfg.mismatch), np.int32(cfg.gap), W,
            strict=want_cigar, mode=mode)
        if not want_cigar:
            cert, scores, goal_i, goal_j = jax.device_get(
                (cert_d, out.score, out.goal_i, out.goal_j))
            packed = None
        else:
            packed_d = tr.pack_codes(tr.walk_parents(
                out.parents, out.goal_i, out.goal_j, out.score,
                qa, ta, cfg.match, cfg.mismatch, cfg.gap, mode=mode,
                band=band_ops.band_width(W)))
            # One combined fetch: one device->host synchronisation.
            cert, packed, scores, goal_i, goal_j = jax.device_get(
                (cert_d, packed_d, out.score, out.goal_i, out.goal_j))
        n_reads = len(seqs)
        with self._counters_lock:
            self.counters.cert_total += n_reads
            self.counters.cert_hits += int(cert[:n_reads].sum())
            self.counters.batches += 1
        cig_by_i: dict = {}
        if want_cigar:
            sel = [i for i in range(n_reads) if cert[i]]
            if sel:
                cigs, tbs = _decode_cigars(
                    packed, sel, goal_i, goal_j,
                    [len(q) for q in qs], [len(t) for t in ts], cfg)
                cig_by_i = dict(zip(sel, zip(cigs, tbs)))
        results: List[ReadMapping] = []
        host_retry: List[int] = []
        for i in range(n_reads):
            _, qb, qe, tb, te, fwd, _ = hints[i]
            if not cert[i]:             # safety net: stage through host
                results.append(ReadMapping(mapped=False))
                host_retry.append(i)
                continue
            cigar, target_begin = cig_by_i.get(i, (None, None))
            results.append(ReadMapping(
                mapped=True, is_fwd=bool(fwd), q_begin=qb, q_end=qe,
                t_begin=tb, t_end=te, score=int(scores[i]),
                cigar=cigar, target_begin=target_begin))
        return results, host_retry

    def _map_bucket_fused(
            self, seqs: Sequence[str], budget: int
    ) -> Tuple[List[ReadMapping], List[int], List[int], dict]:
        """Fused device bucket.  Returns (results, budget_retry, host_retry,
        host_hint): budget_retry reads overflowed (retry fused, doubled
        budget); host_retry reads failed the banded-traceback certificate
        even at the ladder's widest band (re-route through the realign
        pass); host_hint maps each such read to (certifying band, exact
        chain coordinates, score) from this pass - _realign_bucket re-runs
        only the alignment at that band instead of the whole fused step."""
        import jax.numpy as jnp
        from bioinfo1_tpu.pipeline import device_map as dm
        from bioinfo1_tpu.ops.align import MODE_BY_NAME
        cfg = self.cfg
        mesh = self._get_mesh()
        arr, lens = _pack_reads(seqs, cfg.k + cfg.w - 1,
                                min_batch=mesh.size if mesh else 8,
                                len_to=_bucket_cap(
                                    max(len(s) for s in seqs),
                                    cfg.k + cfg.w - 1))
        cap = arr.shape[1]
        region_cap = _region_cap(cap)
        mode = MODE_BY_NAME[cfg.align_type]
        scoring = (jnp.int32(cfg.match), jnp.int32(cfg.mismatch),
                   jnp.int32(cfg.gap))
        # Per-batch read scan (numpy, one pass over B*L bytes) + the init-time
        # genome scan: when neither side can contain '-', the banded kernel
        # drops the free-gap compares/selects (ops/band.py dash_free).
        # Sticky-false (ADVICE r04): a stream alternating dash-containing
        # and dash-free batches would otherwise compile and cache TWO
        # variants of every step; real dash inputs are rare and
        # pathological, so the first dash pins the general kernel for the
        # Mapper's lifetime (bounded 1-variant cache either way).
        dash_free = bool(self._dash_free_sticky and self._ref_dash_free
                         and not (arr == 45).any())
        if not dash_free:
            self._dash_free_sticky = False

        def run(band):
            if cfg.output_cigar:
                key = ("cigar", mode, budget, region_cap, band,
                       cfg.oob_end_windows, dash_free)
            else:
                key = (mode, budget, region_cap, band,
                       cfg.oob_end_windows, dash_free)
            if mesh is not None:
                # Index placement first: the step builder's in_specs depend
                # on whether the index landed replicated or sharded.
                idx = self._get_replicated_index(mesh)
                step = self._get_sharded_step(mesh, key)
                return jax.device_get(step(arr, lens, idx, *scoring))
            fn = dm.map_step_cigar if cfg.output_cigar else dm.map_step
            return jax.device_get(fn(
                jnp.asarray(arr), jnp.asarray(lens),
                self._get_device_index(), *scoring,
                k=cfg.k, w=cfg.w, mode=mode,
                budget=budget, region_cap=region_cap,
                oob_end_windows=cfg.oob_end_windows, band=band,
                dash_free=dash_free))

        cig = None
        if cfg.output_cigar:
            max_band = self._max_fused_band(cap, arr.shape[0])
            # A band persisted under a SMALLER batch can exceed this batch's
            # parent-stream HBM ceiling; clamp instead of relying on the OOM
            # retry ladder to recover (ADVICE r03).
            band = min(self._bucket_band(cap, True), max_band)
            # ONE pass (r05; the r02-r04 in-batch doubling ladder re-ran the
            # whole fused step - front half included - for every miss).
            # Certificate misses go to the batched realign-only pass
            # instead: the banded score here is an exact lower bound, so
            # the band it proves (_needed_band_arr) always certifies there,
            # and the band persistence below still converges the bucket so
            # steady-state misses stay ~1%.
            cig = run(band)
            out = cig.base
            n_real = len(seqs)
            # Persist the band for FUTURE batches: the observed max needed
            # band, capped at 2x the 99th percentile - a miss costs a whole
            # realign dispatch and fetch, so the band
            # should cover every read the workload actually produces, but
            # one chimera-like outlier (needed band ~ whole matrix) must
            # not pin every later batch's parent stream wide; such
            # outliers pay the realign pass instead.
            # Gate on MAPPED (not certified): a bucket whose only reads
            # miss the certificate must still learn a wider band, or every
            # future batch re-pays the realign round trip.
            if out.mapped[:n_real].any():
                need = _needed_band_arr(
                    cig.q_len[:n_real], cig.t_len[:n_real],
                    out.score[:n_real], cfg.match, cfg.mismatch, cfg.gap,
                    mode, strict=True)
                if need is None:
                    persist = band
                else:
                    mapped_need = need[out.mapped[:n_real]]
                    w99 = float(np.percentile(mapped_need, 99))
                    w100 = float(mapped_need.max())
                    persist = -(-int(max(min(w100, 2 * w99), 256))
                                // 128) * 128
                self._band_by_key[(cap, True)] = min(max(persist, 256),
                                                     max_band)
        else:
            band = self._bucket_band(cap, False)
            out = run(band)
            self._adapt_band_score(cap, out, len(seqs))
        results: List[ReadMapping] = []
        retry: List[int] = []
        retry_need: dict = {}
        host_retry: List[int] = []
        host_hint: dict = {}
        cig_by_i: dict = {}
        if cig is not None:
            nm = out.mapped[:len(seqs)]
            with self._counters_lock:
                self.counters.cert_total += int(nm.sum())
                self.counters.cert_hits += int(
                    (nm & cig.certified[:len(seqs)]).sum())
            sel = [i for i in range(len(seqs))
                   if out.mapped[i] and not out.overflow[i]
                   and cig.certified[i]]
            if sel:
                import time as _time
                t_dec = _time.perf_counter()
                cigs, tbs = _decode_cigars(
                    cig.codes, sel, cig.goal_i, cig.goal_j,
                    cig.q_len, cig.t_len, cfg)
                cig_by_i = dict(zip(sel, zip(cigs, tbs)))
                with self._counters_lock:
                    self.counters.t_decode_s += _time.perf_counter() - t_dec
        with self._counters_lock:
            self.counters.batches += 1
        for i in range(len(seqs)):
            if out.overflow[i]:
                results.append(ReadMapping(mapped=False))
                retry.append(i)
                retry_need[i] = int(out.need[i])
            elif not out.mapped[i]:
                results.append(ReadMapping(mapped=False))
            elif cig is not None and not cig.certified[i]:
                results.append(ReadMapping(mapped=False))
                host_retry.append(i)
                need = _needed_band_arr(
                    np.int64(cig.q_len[i]), np.int64(cig.t_len[i]),
                    np.int64(out.score[i]), cfg.match, cfg.mismatch,
                    cfg.gap, mode, strict=True)
                if need is not None:
                    host_hint[i] = (int(need), int(out.q_begin[i]),
                                    int(out.q_end[i]), int(out.t_begin[i]),
                                    int(out.t_end[i]), bool(out.is_fwd[i]),
                                    int(out.score[i]))
            elif cig is None and bool(out.inexact[i]):
                # Score-path certificate miss: the banded score is a lower
                # bound; rerun through the realign pass at the band that
                # bound proves (always certifies there - same argument as
                # the -c cert-miss route).  Replaces the r02-r04 in-jit
                # whole-batch full-wavefront fallback, which fired for a
                # couple of outliers on nearly every repeat-genome batch
                # at ~200 ms each and could not compile past ~24 kb.
                results.append(ReadMapping(mapped=False))
                host_retry.append(i)
                ql_i = min(int(out.q_end[i]) - int(out.q_begin[i]) + 1, cap)
                tl_i = min(int(out.t_end[i]) - int(out.t_begin[i]) + 1,
                           region_cap)
                need = _needed_band_arr(
                    np.int64(ql_i), np.int64(tl_i), np.int64(out.score[i]),
                    cfg.match, cfg.mismatch, cfg.gap, mode, strict=False)
                if need is not None:
                    host_hint[i] = (int(need), int(out.q_begin[i]),
                                    int(out.q_end[i]), int(out.t_begin[i]),
                                    int(out.t_end[i]), bool(out.is_fwd[i]),
                                    int(out.score[i]))
            else:
                cigar, target_begin = cig_by_i.get(i, (None, None))
                results.append(ReadMapping(
                    mapped=True, is_fwd=bool(out.is_fwd[i]),
                    q_begin=int(out.q_begin[i]), q_end=int(out.q_end[i]),
                    t_begin=int(out.t_begin[i]), t_end=int(out.t_end[i]),
                    score=int(out.score[i]), cigar=cigar,
                    target_begin=target_begin))
        # Key -1: the batch-wide exact max need (never collides with the
        # per-read loc keys) - map_batch uses it to DECAY a persisted
        # bucket boost that the workload no longer justifies (e.g. stale
        # cache state), instead of paying the oversized chain DP forever.
        retry_need[-1] = int(out.need[:len(seqs)].max())
        return results, retry, host_retry, host_hint, retry_need

    def map_batch(self, seqs: Sequence[str]) -> List[ReadMapping]:
        cfg = self.cfg
        fused = self._fast_path_ok()
        results: List[ReadMapping] = [None] * len(seqs)  # type: ignore
        pending = list(range(len(seqs)))
        force_host: set = set()     # banded-certificate misses (fused -c)
        oom_retry: set = set()      # transient-OOM reruns: SAME budget
        mult: dict = {}             # per-read budget multiplier (overflow)
        band_hint: dict = {}        # per-read certifying band (fused score)
        budget = cfg.initial_match_budget
        attempts = 0
        while pending:
            # Regions longer than the fused step's cap (chains spanning far
            # more target than query) never resolve by budget doubling;
            # after two fused rounds the stragglers take the host path
            # (OOM-only reruns stay fused - the host path's full-matrix
            # tensors are LARGER than what just failed to fit).
            if attempts >= 2:
                fused = False
            attempts += 1
            # Cert-missed reads with a proven certifying band take the
            # realign-only pass (_realign_bucket): it handles mixed lengths,
            # so ONE dispatch covers every missed read regardless of its
            # length bucket (one round trip instead of one per bucket).
            band_all = [i for i in pending
                        if i in band_hint and i not in force_host]
            band_members = set(band_all)
            rest = [i for i in pending if i not in band_members]
            buckets = _bucket_indices(
                [len(seqs[i]) for i in rest], cfg.bucket_growth,
                cfg.k + cfg.w - 1)
            next_pending: List[int] = []
            grouped = ([(band_all, "band")] if band_all else [])
            grouped += [([rest[j] for j in bucket], None)
                        for bucket in buckets]
            for idxs, forced_kind in grouped:
                # Routes: "band" above; "fused" = the normal path (plus
                # OOM reruns); "host" = staged pipeline for faults,
                # hint-less cert misses and bug-compat.
                band_set = set(idxs) if forced_kind == "band" else set()
                fused_set = {i for i in idxs
                             if (fused or i in oom_retry)
                             and i not in force_host and i not in band_set}
                host_idx = [i for i in idxs
                            if i not in fused_set and i not in band_set]
                pairs = [([i for i in idxs if i in fused_set], "fused"),
                         ([i for i in idxs if i in band_set], "band")]
                # Host-path -c dispatches are memory-bound by their banded
                # parent tensors (up to whole-matrix width after the
                # needed-band retry); 32-read chunks cap that at a few GB
                # even for 8 kb+ regions (VERDICT r03: bug-compat -c must
                # not be unbounded-memory).
                if cfg.output_cigar:
                    pairs += [(host_idx[o:o + 32], "host")
                              for o in range(0, len(host_idx), 32)]
                else:
                    pairs.append((host_idx, "host"))
                for sub_idxs, kind in pairs:
                    if not sub_idxs:
                        continue
                    on_device = kind != "host"
                    sub = [seqs[i] for i in sub_idxs]
                    # Budget scales with the bucket's CAP (a read has
                    # ~2L/(w+1) minimizers, typically ~1 hit each), so long
                    # reads don't start at a budget they are guaranteed to
                    # overflow; match-budget overflows retry at the read's
                    # doubled multiplier, while OOM reruns keep the SAME
                    # budget (doubling what just exhausted HBM could only
                    # fail harder).  Derived from the canonical cap - NOT
                    # the batch's max read length - so the jit key is
                    # stable across batches of the same bucket.
                    max_len = max(len(s) for s in sub)
                    cap = _bucket_cap(max_len, cfg.k + cfg.w - 1)
                    # 3L/8 covers the expected per-strand match total
                    # (~2L/(w+1) surviving minimizers x ~1.05 hits) with
                    # ~10% slack; the old cap/2 padded every match buffer
                    # and the LIS width by ~33% idle lanes.  Overflow
                    # doubles per read via `mult`, and a bucket that
                    # overflows persistently (repeat-dense genomes) bumps
                    # its own base multiplier so FUTURE batches start wide
                    # instead of paying a rerun each (the tight default
                    # halved repeat-genome throughput via retry batches).
                    b_budget = max(_pow2_at_least(budget, 8),
                                   -(-3 * cap // (8 * 128)) * 128)
                    # Bucket boost and per-read retry multipliers BOTH
                    # target absolute budgets that cover an observed need,
                    # so combine with max, not product: multiplying them
                    # squared the budget (boost 8 x mult 8 = 64x) the one
                    # time both were live, and the chain DP at that width
                    # ran ~1000x slow.
                    b_budget *= max(self._budget_boost.get(cap, 1),
                                    max(mult.get(i, 1) for i in sub_idxs))
                    # Per-batch fault isolation (VERDICT r02 item 8; the
                    # reference's analog catches a per-read Align throw,
                    # logs, and continues - team_mapper.cpp:663-683).  An
                    # unexpected failure in the fused device path re-routes
                    # the batch through the host pipeline; a host-path
                    # failure skips those reads with the reference's stderr
                    # line instead of aborting the whole run.
                    import time as _time
                    t_call = _time.perf_counter()
                    try:
                        need = {}
                        if kind == "band":
                            res, host_retry = self._realign_bucket(
                                sub, {loc: band_hint[i]
                                      for loc, i in enumerate(sub_idxs)})
                            retry = []
                            hints = {}
                        elif on_device:
                            res, retry, host_retry, hints, need = \
                                self._map_bucket_fused(sub, b_budget)
                        else:
                            res, retry = _map_bucket(
                                sub, self.index, cfg, b_budget,
                                band_hint=max(
                                    (band_hint.get(i, (0,))[0]
                                     for i in sub_idxs), default=0))
                            host_retry = []
                            hints = {}
                    except Exception as e:
                        with self._counters_lock:
                            self.counters.faults += 1
                        print(f"ERROR: Exception during Align: {e}",
                              file=sys.stderr)
                        if on_device:
                            # Transient HBM exhaustion (concurrent batches
                            # in flight): retry FUSED at the SAME budget
                            # after the pressure drains; only give up to
                            # the host path after several attempts or on a
                            # non-OOM failure.
                            if ("RESOURCE_EXHAUSTED" in str(e)
                                    and attempts < 6):
                                oom_retry.update(sub_idxs)
                            else:
                                force_host.update(sub_idxs)
                            next_pending.extend(sub_idxs)
                        else:
                            for i in sub_idxs:
                                results[i] = ReadMapping(mapped=False)
                        continue
                    retry_s, host_s = set(retry), set(host_retry)
                    # >2% of a batch overflowing marks the bucket as
                    # repeat-dense: widen its future starting budget to
                    # cover the EXACT observed need (MapOut.need carries
                    # the pre-truncation match totals) - one observation
                    # converges the bucket, where the old fixed-8x-capped
                    # doubling forced per-read retry batches on every pass
                    # of a ~30-copy repeat genome (VERDICT r04 item 10).
                    # The absolute cap keeps the boosted budget within the
                    # chain kernel's packed-index range and HBM.
                    base = max(_pow2_at_least(budget, 8),
                               -(-3 * cap // (8 * 128)) * 128)
                    if len(retry_s) > max(2, len(sub_idxs) // 50):
                        need_max = max((need.get(loc, 0)
                                        for loc in retry_s), default=0)
                        boost = max(self._budget_boost.get(cap, 1) * 2,
                                    _pow2_at_least(
                                        -(-21 * need_max // (20 * base)), 1))
                        while boost > 1 and base * boost > 32768:
                            boost //= 2
                        self._budget_boost[cap] = boost
                    elif (kind == "fused" and not retry_s
                          and self._budget_boost.get(cap, 1) > 1
                          and 0 < need.get(-1, 0) * 21 // 20
                          <= base * self._budget_boost[cap] // 2):
                        # Clean batch whose exact max need fits HALF the
                        # boosted budget: decay one step.  Heals stale
                        # persisted boosts (the oversized chain DP costs
                        # every batch) while honest boosts - where need
                        # really is near the budget - stay put.
                        self._budget_boost[cap] //= 2
                    dt_call = _time.perf_counter() - t_call
                    with self._counters_lock:
                        if on_device:
                            self.counters.t_fused_s += dt_call
                        else:
                            self.counters.t_host_s += dt_call
                            self.counters.batches += 1
                        self.counters.budget_retries += len(retry_s)
                        self.counters.host_fallbacks += len(host_s)
                    for loc, i in enumerate(sub_idxs):
                        if loc in retry_s:
                            # Jump straight to a multiplier covering the
                            # exact observed need (with 5% slack); plain
                            # doubling remains the floor so compact-stage
                            # overflows (need underestimates them) still
                            # make progress.
                            jump = _pow2_at_least(
                                -(-21 * need.get(loc, 0) // (20 * base)), 1)
                            mult[i] = max(mult.get(i, 1) * 2, jump)
                            next_pending.append(i)
                        elif loc in host_s:
                            # First miss with a provable band -> fused
                            # rerun at that band; a second miss (or no
                            # finite band) -> staged host path.
                            if kind == "fused" and loc in hints:
                                band_hint[i] = hints[loc]
                            else:
                                band_hint.pop(i, None)
                                force_host.add(i)
                            next_pending.append(i)
                        else:
                            oom_retry.discard(i)
                            results[i] = res[loc]
            pending = next_pending
            if attempts >= 24:  # safety: ~16M matches per read
                for i in pending:
                    results[i] = ReadMapping(mapped=False)
                break
        cells = 0.0
        n_mapped = 0
        for r in results:
            if r is not None and r.mapped:
                n_mapped += 1
                cells += float((r.q_end - r.q_begin + 1)
                               * (r.t_end - r.t_begin + 1))
        with self._counters_lock:
            self.counters.reads += len(seqs)
            self.counters.mapped += n_mapped
            self.counters.dp_cells += cells
        return results

    def _format_chunk(self, chunk: Sequence[Tuple[str, str]],
                      mappings: Sequence[ReadMapping],
                      per_read_stats: bool) -> List[List[str]]:
        """Per-record output lines for one mapped chunk (stats + PAF)."""
        cfg = self.cfg
        per_rec: List[List[str]] = [[] for _ in chunk]
        if per_read_stats:
            # One batched device sweep replaces the O(L*w*k) host oracle
            # per read; the window-win stream (duplicates included) is
            # identical to rm.minimize's emit list.
            from bioinfo1_tpu.utils import stats as st
            arr, lens = _pack_reads([seq for _, seq in chunk],
                                    cfg.k + cfg.w - 1)
            sres = mz.minimize_batch(arr, lens, cfg.k, cfg.w,
                                     oob_end_windows=cfg.oob_end_windows)
            stat_h = np.asarray(jax.device_get(sres.hashes))
            stat_v = np.asarray(jax.device_get(sres.valid))
            for bi in range(len(chunk)):
                per_rec[bi].append(st.read_statistics(stat_h[bi],
                                                      stat_v[bi]))
        # Native batch serializer (native/paf.cpp) - C++ formatting like the
        # reference's (team_mapper.cpp:685-698); paf_line is the fallback
        # and executable spec.  It emits one line per MAPPED read in order.
        from bioinfo1_tpu import native
        nat = native.paf_format(
            [name for name, _ in chunk], [len(seq) for _, seq in chunk],
            mappings, self.ref_name, self.ref_len, cfg.output_cigar)
        if nat is not None:
            it = iter(nat)
            for bi, m in enumerate(mappings):
                if m.mapped:
                    per_rec[bi].append(next(it))
        else:
            for bi, ((name, seq), m) in enumerate(zip(chunk, mappings)):
                if m.mapped:
                    per_rec[bi].append(paf_line(
                        name, len(seq), m, self.ref_name, self.ref_len,
                        cfg.output_cigar))
        return per_rec

    def map_records_iter(self, records: Sequence[Tuple[str, str]],
                         per_read_stats: bool = False, start_at: int = 0):
        """Yield (next_record_index, lines) in input order.

        Records accumulate into per-length-bucket queues that flush at a
        FIXED size (the pow-2 batch size), so every steady-state device
        batch has the same padded shape - one jit specialization per bucket
        instead of a recompile whenever a window's bucket census crosses a
        pow-2 boundary - and short/long reads never share (and thus pad)
        one bucket's dispatch.  Completed records are buffered until their
        input-order turn; yields carry the contiguous completed prefix, so
        checkpoint/resume (``start_at``; the reference restarts from
        scratch, SURVEY.md section 5) stays exact.
        """
        from concurrent.futures import ThreadPoolExecutor
        cfg = self.cfg
        flush_size = _pow2_at_least(cfg.batch_size, 8)
        floor = cfg.k + cfg.w - 1
        queues: dict = {}               # cap -> [(idx, name, seq), ...]
        results: dict = {}              # idx -> [lines]
        emitted = start_at
        n_queued = 0
        # Pipelined map_batch calls on worker threads, so while batch k's
        # results are fetched and decoded on the host, batch k+1's upload
        # and device execution proceed.  Device execution still serializes
        # on the device's queue; per-read results are keyed by input index,
        # so completion order cannot affect output order.  The
        # inflight-bytes valve below serializes batches whose parent
        # streams would overflow device memory together.
        DEPTH = 3
        # Device-memory pressure bound: the device holds the replicated
        # index (~4.4 GB for E. coli at the direct-address directory) plus
        # every in-flight batch's transient workspaces; unbounded
        # concurrency runs out of memory on big read buckets.  Cap the
        # ESTIMATED transient bytes dispatched concurrently (_flush_cost)
        # at INFLIGHT_SHARE of the device's memory.
        import os as _os
        max_inflight_bytes = int(float(_os.environ.get(
            "BIOINFO1_INFLIGHT_BYTES", _device_budget(INFLIGHT_SHARE, 7e9))))

        def _flush_cost(n_entries: int, cap: int) -> int:
            bpad = _batch_cap(n_entries, 8)
            cost = bpad * cap * 320
            if cfg.output_cigar:
                # Packed parent stream: ~(2*cap+W) diagonal rows x W/4
                # bytes per read (2 bits per band cell, ops/band.py), plus
                # the walk's codes.
                W = self._bucket_band(cap, True)
                cost += bpad * W * ((2 * cap + W) // 4 + 64)
            return cost

        executor = ThreadPoolExecutor(max_workers=DEPTH)
        in_flight: list = []            # FIFO [(entries, chunk, fut, cost)]

        def complete_oldest():
            import time as _time
            entries, chunk, fut, _bases = in_flight.pop(0)
            mappings = fut.result()
            t_fmt = _time.perf_counter()
            per_rec = self._format_chunk(chunk, mappings, per_read_stats)
            with self._counters_lock:
                self.counters.t_format_s += _time.perf_counter() - t_fmt
            for (idx, _, _), lines in zip(entries, per_rec):
                results[idx] = lines

        def complete_in_flight():
            while in_flight:
                complete_oldest()

        def flush(cap):
            nonlocal n_queued
            entries = queues.pop(cap)
            n_queued -= len(entries)
            chunk = [(name, seq) for _, name, seq in entries]
            cost = _flush_cost(len(entries), cap)
            while in_flight and (
                    len(in_flight) >= DEPTH
                    or sum(b for *_x, b in in_flight) + cost
                    > max_inflight_bytes):
                complete_oldest()
            fut = executor.submit(self.map_batch, [seq for _, seq in chunk])
            in_flight.append((entries, chunk, fut, cost))

        def drain():
            nonlocal emitted
            lines: List[str] = []
            while emitted in results:
                lines.extend(results.pop(emitted))
                emitted += 1
            return lines

        last_yield = start_at
        # Pressure valve (ADVICE r02): a bucket that never reaches
        # flush_size would otherwise pin `emitted` forever, buffering every
        # later record's lines in `results` and freezing checkpoint
        # progress.  Keyed on STALENESS of the oldest queued record (how
        # many records arrived after it), not on total occupancy: with many
        # active length buckets the steady-state occupancy alone exceeds
        # any small bound, and an occupancy-keyed valve would fire on every
        # record - serializing the pipeline and flushing undersized batches
        # (a code-review finding).  A large occupancy hard-cap stays as the
        # memory backstop.  Each valve flush targets the bucket holding the
        # oldest record and completes synchronously, so it provably
        # advances the checkpoint.
        stale_window = 16 * flush_size
        hard_cap = 64 * flush_size
        try:
            for idx in range(start_at, len(records)):
                name, seq = records[idx]
                cap = _bucket_cap(len(seq), floor)
                queues.setdefault(cap, []).append((idx, name, seq))
                n_queued += 1
                lines: List[str] = []
                if len(queues[cap]) >= flush_size:
                    flush(cap)
                    lines.extend(drain())
                def limbo():
                    # queued + completed-but-unemitted + dispatched-in-flight
                    return (n_queued + len(results)
                            + sum(len(e) for e, *_rest in in_flight))
                while queues:
                    oldest = min(queues, key=lambda c: queues[c][0][0])
                    if (idx - queues[oldest][0][0] < stale_window
                            and limbo() < hard_cap):
                        break
                    flush(oldest)
                    complete_in_flight()
                    lines.extend(drain())
                if lines or emitted > last_yield:
                    last_yield = emitted
                    yield emitted, lines
            while queues:
                flush(next(iter(queues)))
            complete_in_flight()
            lines = drain()
            if lines or emitted > last_yield:
                yield emitted, lines
        finally:
            executor.shutdown(wait=True)
            self._save_band_cache()

    def map_records(self, records: Sequence[Tuple[str, str]],
                    per_read_stats: bool = False) -> List[str]:
        """Map (name, seq) records to output lines in deterministic input order.

        ``per_read_stats`` mirrors the -s per-read block printed inside the
        reference's FASTA mapping loop (team_mapper.cpp:610-624): for every
        read (mapped or not), a distinct-minimizer count and singleton
        fraction block precedes the read's PAF line - matching the
        single-threaded reference's interleaving on the same stream.
        """
        out: List[str] = []
        for _, lines in self.map_records_iter(records, per_read_stats):
            out.extend(lines)
        return out


def map_all(reference_records: Sequence[Tuple[str, str]],
            read_records: Sequence[Tuple[str, str]],
            cfg: MapperConfig) -> List[str]:
    """One-shot convenience wrapper mirroring reference_model.map_all."""
    return Mapper(reference_records, cfg).map_records(read_records)
