#!/usr/bin/env python
"""Headline benchmark: reads/s through the fused device map step.

Workload: synthetic E. coli-scale genome (4.6 Mbp) and ONT-like 4 kb reads
with 2% point errors - the shape of the MAP006 x K-12 evaluation the
reference's report describes (BASELINE.md; the real dataset is not shipped
in the reference repo).

Baseline denominator: the reference C++ binary (OMP_NUM_THREADS=1) on the
same genome and a read subset, measured once and cached in
build/bench_baseline.json.  vs_baseline = our reads/s divided by the
reference's single-core reads/s.

Runs on a GPU only: with no GPU, or if a measurement fails, it exits
non-zero and prints no result.  Prints ONE JSON line: {"metric", "value",
"unit", "vs_baseline", "extra"}; "extra" names the device (platform,
device_kind, device count, and the card's name and power limit).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

GENOME_LEN = 4_641_652      # E. coli K-12 MG1655 size (BASELINE.md)
READ_LEN = 4096
N_READS = 1024              # timed total (4 chained device batches)
BATCH = 256                 # reads per device step
K, W, F = 15, 5, 0.001
SEED = 20250817
BAND = 128                  # banded wavefront width (certified-exact)


def make_data():
    import numpy as np
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"CATG", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, GENOME_LEN)]
    reads = np.zeros((N_READS, READ_LEN), dtype=np.uint8)
    for i in range(N_READS):
        start = int(rng.integers(0, GENOME_LEN - READ_LEN))
        r = genome[start:start + READ_LEN].copy()
        nmut = int(READ_LEN * 0.02)
        pos = rng.integers(0, READ_LEN, nmut)
        r[pos] = bases[rng.integers(0, 4, nmut)]
        reads[i] = r
    lens = np.full((N_READS,), READ_LEN, dtype=np.int32)
    return genome, reads, lens


def measure_ours(genome, reads, lens):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from bioinfo1_tpu.utils.runtime import configure_jax
    configure_jax()
    from bioinfo1_tpu.index import builder
    from bioinfo1_tpu.pipeline import device_map as dm

    jax.block_until_ready(jax.device_put(np.zeros(1024, np.uint8)))

    genome_str = genome.tobytes().decode("latin1")
    t0 = time.time()
    index = builder.build_index(genome_str, K, W, F)
    didx = dm.device_index_from_host(index)
    jax.block_until_ready(jax.tree.leaves(didx))
    t_index = time.time() - t0

    m, n, g = jnp.int32(1), jnp.int32(-1), jnp.int32(-1)
    # ~2L/(w+1) minimizers per read, ~1 hit each on a random genome; 2048
    # covers 4kb reads with slack (overflow is flagged, not silent).
    budget = 2048

    # One upfront upload and scalar-only fetches: all per-batch slicing and
    # the mapped/cell reductions stay on device.
    reads_d = jax.device_put(reads)
    lens_d = jax.device_put(lens)
    jax.block_until_ready(reads_d)

    def run_batch(i):
        rb = jax.lax.dynamic_slice_in_dim(reads_d, i, BATCH, axis=0)
        lb = jax.lax.dynamic_slice_in_dim(lens_d, i, BATCH, axis=0)
        out = dm.map_step(rb, lb, didx, m, n, g, k=K, w=W, mode=0,
                          budget=budget, region_cap=2 * READ_LEN, band=BAND)
        cells = jnp.sum(
            jnp.where(out.mapped,
                      (out.q_end - out.q_begin + 1).astype(jnp.float32)
                      * (out.t_end - out.t_begin + 1), 0.0))
        return jnp.sum(out.mapped), cells, jnp.sum(out.score)

    # Every timed region ends with a device_get of a value that depends on
    # ALL batches.
    def full_pass():
        t0 = time.time()
        mapped_a = jnp.int32(0)
        cells_a = jnp.float32(0)
        chk = jnp.int32(0)
        for i in range(0, N_READS, BATCH):
            mb, cb, sb = run_batch(i)
            mapped_a = mapped_a + mb
            cells_a = cells_a + cb
            chk = chk + sb
        mapped, cells, _ = jax.device_get((mapped_a, cells_a, chk))
        return time.time() - t0, int(mapped), float(cells)

    # Compile + warm (the first executed pass after compile still pays
    # one-time autotune costs); report the best of two steady passes.
    full_pass()
    dt1, mapped, cells = full_pass()
    dt2, _, _ = full_pass()
    dt = min(dt1, dt2)

    reads_per_s = N_READS / dt
    gcups = cells / dt / 1e9
    return reads_per_s, mapped, t_index, gcups


def make_product_mapper(genome):
    """One shared Mapper for every product-path bench: each Mapper carries
    its own ~4.4 GB device index replica (direct-address directory), so
    building one per measure would stack replicas in HBM and OOM the later
    measurements."""
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig
    genome_str = genome.tobytes().decode("latin1")
    return Mapper([("ref", genome_str)], MapperConfig())


def measure_product(genome, mapper):
    """Product-path benches: the bucketed Mapper pipeline the CLI runs.

    (a) mixed-length score-only mapping (1.5/3/6 kb reads - three buckets),
    (b) the -c CIGAR path on 4 kb reads (fused banded parents + device walk
        + host RLE).
    Returns (mixed_reads_per_s, mixed_bases_per_s, cigar_reads_per_s).
    """
    import dataclasses
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(SEED + 1)
    bases = np.frombuffer(b"CATG", dtype=np.uint8)
    genome_str = genome.tobytes().decode("latin1")

    def make_reads(lengths):
        recs = []
        for i, ln in enumerate(lengths):
            start = int(rng.integers(0, len(genome) - ln))
            r = genome[start:start + ln].copy()
            pos = rng.integers(0, ln, ln // 50)
            r[pos] = bases[rng.integers(0, 4, len(pos))]
            recs.append((f"r{i}", r.tobytes().decode("latin1")))
        return recs

    # Steady-state sizing: each length bucket fills the shipped 512-read
    # flush (and the -c run fills it twice), so the timed region measures
    # the pipelined per-flush behavior a real whole-file run sees, not one
    # undersized tail batch.
    mixed = make_reads([1500, 3000, 6000] * 512)        # 1536 reads, 3 buckets
    cig = make_reads([4096] * 1024)

    cfg = MapperConfig()        # CLI defaults (batch_size=512)

    def timed(records):
        # Warm until the adaptive bands AND budget boosts stop moving: a
        # knob that shifts after the last warm pass changes the jit key
        # and puts a fresh compile inside the timed region (measured as a
        # 40x "regression" once).
        for _ in range(4):
            before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
            mapper.map_records(records)                  # warm/compile
            if (dict(mapper._band_by_key),
                    dict(mapper._budget_boost)) == before:
                break
        t0 = time.time()
        lines = mapper.map_records(records)
        dt = time.time() - t0
        assert len(lines) >= len(records) * 9 // 10, "too few reads mapped"
        return dt

    dt_mixed = timed(mixed)
    mixed_rps = len(mixed) / dt_mixed
    mixed_bps = sum(len(s) for _, s in mixed) / dt_mixed

    mapper.cfg = dataclasses.replace(cfg, output_cigar=True)
    cigar_rps = len(cig) / timed(cig)
    return mixed_rps, mixed_bps, cigar_rps


def measure_repeat(genome_len=GENOME_LEN):
    """Repeat-structured genome at product scale (VERDICT r03 item 3):
    E. coli-like repeat census (utils/simulate.repeat_genome) so the
    frequency ban, match-budget overflow ladder and repeat-dense LIS
    actually fire (a uniform-random genome leaves them idle).  Builds its
    OWN index - call after the other product benches and drop their mapper
    first (two 4+ GB device indexes do not fit HBM together).
    Returns {"repeat_reads_per_s", "repeat_counters"}."""
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import (Mapper, MapperConfig,
                                              MapperCounters)
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(SEED + 5)
    genome = sim.repeat_genome(genome_len, rng)
    # Mixed error profile like MAP006: half ~12%-error reads, half
    # low-error 2D-quality reads (~3%).  Low-error reads keep most of
    # their minimizers, so ones landing in the near-identical operon
    # repeats multiply matches past the budget and drive the
    # overflow-retry ladder (budget_retries > 0 expected).
    records = sim.simulate_reads(genome, [2000, 4000, 8000] * 171, rng)
    records += sim.simulate_reads(genome, [2000, 4000, 8000] * 171, rng,
                                  sub_rate=0.015, ins_rate=0.007,
                                  del_rate=0.008)
    import dataclasses
    mapper = Mapper([("ref", genome.tobytes().decode("latin1"))],
                    MapperConfig())
    for _ in range(4):
        before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
        mapper.map_records(records)
        if (dict(mapper._band_by_key), dict(mapper._budget_boost)) == before:
            break
    mapper.counters = MapperCounters()
    t0 = time.time()
    lines = mapper.map_records(records)
    dt = time.time() - t0
    t0 = time.time()
    mapper.map_records(records)
    dt = min(dt, time.time() - t0)
    assert len(lines) >= len(records) * 8 // 10, "too few repeat reads mapped"
    counters = mapper.counters.as_dict()
    # -c on the repeat workload too (VERDICT r04 item 2: no repeat-genome
    # CIGAR number was reported at all).
    mapper.cfg = dataclasses.replace(mapper.cfg, output_cigar=True)
    for _ in range(3):
        before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
        mapper.map_records(records)
        if (dict(mapper._band_by_key), dict(mapper._budget_boost)) == before:
            break
    t0 = time.time()
    clines = mapper.map_records(records)
    dt_c = time.time() - t0
    t0 = time.time()
    mapper.map_records(records)
    dt_c = min(dt_c, time.time() - t0)
    assert len(clines) >= len(records) * 8 // 10
    return {"repeat_reads_per_s": len(records) / dt,
            "repeat_cigar_reads_per_s": len(records) / dt_c,
            "repeat_counters": counters}


def measure_longread(genome, mapper):
    """>= 20 kb ONT-like reads through the product pipeline (VERDICT r04
    item 4: the report's oracle read is 11,265 bp and MAP006 2D reads reach
    tens of kb; nothing previously demonstrated the bucket ladder / VMEM
    guards past 8 kb on the real chip).  128 x 20 kb reads score-only and
    -c, plus 32 x 50 kb score-only."""
    import dataclasses
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import MapperConfig
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(SEED + 7)
    recs20 = sim.simulate_reads(genome, [20000] * 128, rng)
    recs50 = sim.simulate_reads(genome, [50000] * 32, rng)

    def timed(records, cfg):
        mapper.cfg = cfg
        for _ in range(4):
            before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
            mapper.map_records(records)
            if (dict(mapper._band_by_key),
                    dict(mapper._budget_boost)) == before:
                break
        t0 = time.time()
        lines = mapper.map_records(records)
        dt = time.time() - t0
        t0 = time.time()
        mapper.map_records(records)
        dt = min(dt, time.time() - t0)
        assert len(lines) >= len(records) * 9 // 10, "too few long reads"
        return len(records) / dt, sum(len(s) for _, s in records) / dt

    r20, b20 = timed(recs20, MapperConfig())
    r20c, _ = timed(recs20, MapperConfig(output_cigar=True))
    mapper.cfg = MapperConfig()
    r50, b50 = timed(recs50, MapperConfig())
    return {"longread_20k_reads_per_s": round(r20, 2),
            "longread_20k_bases_per_s": round(b20),
            "longread_20k_cigar_reads_per_s": round(r20c, 2),
            "longread_50k_reads_per_s": round(r50, 2),
            "longread_50k_bases_per_s": round(b50)}


def measure_cold_start(genome, mapper):
    """First-run throughput with the band/budget adaptation state RESET
    (VERDICT r04 item 8): one cold pass of a 4 kb workload, so the
    adaptation tax (full-width fallback passes, band learning, any fresh
    band-key compiles) is visible next to the steady-state headline.
    Reuses the shared mapper's device index (a second replica would not
    fit HBM); the learned state is restored afterwards."""
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import MapperConfig
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(SEED + 8)
    records = sim.simulate_reads(genome, [4000] * 512, rng)
    saved_bands = dict(mapper._band_by_key)
    saved_boost = dict(mapper._budget_boost)
    mapper.cfg = MapperConfig()
    try:
        mapper._band_by_key.clear()
        mapper._budget_boost.clear()
        t0 = time.time()
        lines = mapper.map_records(records)
        dt = time.time() - t0
    finally:
        mapper._band_by_key.clear()
        mapper._band_by_key.update(saved_bands)
        mapper._budget_boost.clear()
        mapper._budget_boost.update(saved_boost)
    assert len(lines) >= len(records) * 9 // 10
    return {"cold_start_reads_per_s": round(len(records) / dt, 2)}


def measure_baseline(genome, reads):
    """Reference binary reads/s, single-core AND all-cores OpenMP (its
    shipped configuration, team_mapper.cpp:596) - both denominators cached.
    Returns a dict {"reads_per_s": st, "reads_per_s_omp": omp}.

    The single-thread denominator is PINNED (VERDICT r04 item 6): a
    2,048-read marginal-rate measurement committed to the repo
    (BASELINE_MEASURED.json) overrides any freshly measured number, so
    vs_baseline stops carrying the +-20% machine-load noise of re-measuring
    the ~2-minute reference run every round."""
    pinned = os.path.join(REPO, "BASELINE_MEASURED.json")
    if os.path.exists(pinned):
        with open(pinned) as fh:
            d = json.load(fh)
        d.setdefault("reads_per_s_omp", None)
        d.setdefault("pinned", True)
        return d
    cache = os.path.join(REPO, "build", "bench_baseline.json")
    if os.path.exists(cache):
        with open(cache) as fh:
            d = json.load(fh)
        if "reads_per_s_omp" in d:
            return d
    else:
        d = None
    oracle = os.path.join(REPO, "build", "reference_mapper")
    if not os.path.exists(oracle):
        r = subprocess.run([os.path.join(REPO, "tools",
                                         "build_reference_oracle.sh")],
                           capture_output=True)
        if r.returncode != 0 or not os.path.exists(oracle):
            return None
    import tempfile
    sub = min(129, len(reads))
    with tempfile.TemporaryDirectory() as td:
        ref_path = os.path.join(td, "ref.fasta")
        with open(ref_path, "w") as fh:
            fh.write(">ref\n")
            fh.write(genome.tobytes().decode("latin1"))
            fh.write("\n")

        def run_n(n, threads):
            env = dict(os.environ, OMP_NUM_THREADS=str(threads))
            reads_path = os.path.join(td, f"reads{n}.fasta")
            with open(reads_path, "w") as fh:
                for i in range(n):
                    fh.write(f">r{i}\n"
                             f"{reads[i].tobytes().decode('latin1')}\n")
            t0 = time.time()
            r = subprocess.run([oracle, ref_path, reads_path], env=env,
                               capture_output=True, timeout=3600)
            return time.time() - t0, r.returncode

        # Marginal per-read cost: the reference re-parses and re-indexes the
        # genome every run (~19 s fixed); differencing a 1-read and a
        # sub-read run removes that fixed cost so the denominator is the
        # per-read mapping rate (the fairer comparison - our timed loop also
        # excludes index build).  Min-of-2 runs tames the index-build noise,
        # which is of the same order as the marginal cost itself.
        ncpu = os.cpu_count() or 1
        if d is None:
            t_one = min(run_n(1, 1)[0], run_n(1, 1)[0])
            t_sub = min(run_n(sub, 1)[0], run_n(sub, 1)[0])
            d = {"reads_per_s": (sub - 1) / max(t_sub - t_one, 1e-6),
                 "n_reads": sub, "wall_s": t_sub, "fixed_s": t_one}
        # All-cores marginal cost shrinks by ncpu, so use the full read set
        # (not the 129-read subset) to keep the differenced time well above
        # the ~1 s index-build noise floor.  NOTE: the reference's shipped
        # OpenMP configuration has a fatal data race (shared namespace-scope
        # KMER state mutated by every thread, team_minimizers.cpp:19-22 under
        # team_mapper.cpp:596) - at this workload it SEGFAULTS with >1
        # thread.  Record that honestly instead of a garbage rate.
        sub_o = len(reads)
        t_one_o, rc1 = run_n(1, ncpu)
        t_sub_o, rc2 = run_n(sub_o, ncpu)
        if rc1 != 0 or rc2 != 0:
            d["reads_per_s_omp"] = None
            d["omp_crashed"] = True
        else:
            t_one_o = min(t_one_o, run_n(1, ncpu)[0])
            t_sub_o = min(t_sub_o, run_n(sub_o, ncpu)[0])
            d["reads_per_s_omp"] = (sub_o - 1) / max(t_sub_o - t_one_o, 1e-3)
        d["omp_threads"] = ncpu
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    with open(cache, "w") as fh:
        json.dump(d, fh)
    return d


def measure_indel(genome, mapper):
    """ONT-realistic workload (VERDICT r02 item 1 / r03 item 1): ~12% total
    error with indels (utils/simulate.py), mixed 2/4/8 kb lengths, through
    the PRODUCT pipeline - BOTH score-only and the full -c CIGAR
    configuration (the regime a user of the reference's `-c` actually
    runs).  1,536 reads per measurement, multi-second timed regions.
    Returns {"indel_reads_per_s", "indel_counters",
    "cigar_indel_reads_per_s", "cigar_indel_counters"}."""
    import dataclasses
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import MapperConfig, MapperCounters
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(SEED + 2)
    # 3072 reads = 6 full flushes: the 3-deep pipeline reaches steady
    # state and the tail batch's codes fetch amortizes (a 3-flush region
    # charged one whole exposed fetch+decode to the -c rate).
    lengths = [2000, 4000, 8000] * 1024             # 3072 reads, 3 buckets
    records = sim.simulate_reads(genome, lengths, rng)

    def timed(cfg):
        mapper.cfg = cfg
        # Warm until the adaptive bands AND budget boosts stabilize: the
        # first pass runs at the defaults, adaptation moves the jit keys,
        # and the NEXT pass compiles those specializations - timing before
        # convergence would charge one-time compiles to the steady state.
        for _ in range(5):
            before = (dict(mapper._band_by_key), dict(mapper._budget_boost))
            mapper.map_records(records)
            if (dict(mapper._band_by_key),
                    dict(mapper._budget_boost)) == before:
                break
        mapper.counters = MapperCounters()
        t0 = time.time()
        lines = mapper.map_records(records)
        dt = time.time() - t0
        counters = mapper.counters.as_dict()
        # Best of three timed passes: single ~1 s passes jitter.
        for _ in range(2):
            t0 = time.time()
            mapper.map_records(records)
            dt = min(dt, time.time() - t0)
        assert len(lines) >= len(records) * 9 // 10, "too few reads mapped"
        return len(records) / dt, counters

    score_rps, score_counters = timed(MapperConfig())
    cigar_rps, cigar_counters = timed(MapperConfig(output_cigar=True))
    mapper.cfg = MapperConfig()                     # shared mapper: reset -c
    return {
        "indel_reads_per_s": score_rps,
        "indel_counters": score_counters,
        "cigar_indel_reads_per_s": cigar_rps,
        "cigar_indel_counters": cigar_counters,
        "cigar_indel_pct_of_score": round(100 * cigar_rps / score_rps, 1),
    }


def device_info():
    """The device as JAX reports it, plus the card's name and power limit
    from nvidia-smi (a card set below its maximum runs slower)."""
    import jax
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "card": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 and smi.stdout.strip() else None}


def run_measurement():
    """Child-process entry: measure and print the JSON line.  Exits
    non-zero on a host without a GPU: a CPU number is never reported."""
    from bioinfo1_tpu.utils.runtime import configure_jax
    configure_jax()
    device = device_info()
    if device["platform"] != "gpu":
        print(f"bench needs a GPU, found {device['platform']}",
              file=sys.stderr)
        sys.exit(1)
    genome, reads, lens = make_data()
    ours, mapped, t_index, gcups = measure_ours(genome, reads, lens)
    product_mapper = None
    try:
        product_mapper = make_product_mapper(genome)
        mixed_rps, mixed_bps, cigar_rps = measure_product(
            genome, product_mapper)
    except Exception as e:  # product bench must not sink the headline
        mixed_rps = mixed_bps = cigar_rps = None
        print(f"product bench failed: {e}", file=sys.stderr)
    try:
        if product_mapper is None:
            product_mapper = make_product_mapper(genome)
        indel = measure_indel(genome, product_mapper)
    except Exception as e:
        indel = {"indel_counters": {"error": str(e)}}
        print(f"indel bench failed: {e}", file=sys.stderr)
    indel_rps = indel.get("indel_reads_per_s")
    try:
        if product_mapper is None:
            product_mapper = make_product_mapper(genome)
        longread = measure_longread(genome, product_mapper)
    except Exception as e:
        longread = {"error": str(e)}
        print(f"longread bench failed: {e}", file=sys.stderr)
    try:
        if product_mapper is None:
            product_mapper = make_product_mapper(genome)
        cold = measure_cold_start(genome, product_mapper)
    except Exception as e:
        cold = {"error": str(e)}
        print(f"cold-start bench failed: {e}", file=sys.stderr)
    try:
        # Free the random-genome mapper's ~4.4 GB device index before the
        # repeat bench builds its own.
        del product_mapper
        import gc
        gc.collect()
        repeat = measure_repeat()
    except Exception as e:
        repeat = {"repeat_counters": {"error": str(e)}}
        print(f"repeat bench failed: {e}", file=sys.stderr)
    finally:
        product_mapper = None
    bl = measure_baseline(genome, reads)
    base = bl["reads_per_s"] if bl else None
    base_omp = bl.get("reads_per_s_omp") if bl else None
    vs = (ours / base) if base else None
    scaling = None
    scaling_path = os.path.join(REPO, "SCALING.json")
    if os.path.exists(scaling_path):
        with open(scaling_path) as fh:
            scaling = json.load(fh).get("efficiency", {}).get("2")
    print(json.dumps({
        "metric": "reads_per_s_4kb_ecoli",
        "value": round(ours, 2),
        "unit": "reads/s",
        "vs_baseline": round(vs, 2) if vs else None,
        "extra": {"mapped": mapped, "n_reads": N_READS,
                  "index_build_s": round(t_index, 2),
                  "gcups": round(gcups, 3),
                  "product_mixed_reads_per_s":
                      round(mixed_rps, 2) if mixed_rps else None,
                  "product_mixed_bases_per_s":
                      round(mixed_bps) if mixed_bps else None,
                  "cigar_reads_per_s":
                      round(cigar_rps, 2) if cigar_rps else None,
                  "indel_reads_per_s":
                      round(indel_rps, 2) if indel_rps else None,
                  "indel_vs_baseline":
                      round(indel_rps / base, 2) if (indel_rps and base)
                      else None,
                  "indel_counters": indel.get("indel_counters"),
                  "cigar_indel_reads_per_s":
                      round(indel["cigar_indel_reads_per_s"], 2)
                      if indel.get("cigar_indel_reads_per_s") else None,
                  "cigar_indel_pct_of_score":
                      indel.get("cigar_indel_pct_of_score"),
                  "cigar_indel_counters":
                      indel.get("cigar_indel_counters"),
                  "repeat_reads_per_s":
                      round(repeat["repeat_reads_per_s"], 2)
                      if repeat.get("repeat_reads_per_s") else None,
                  "repeat_cigar_reads_per_s":
                      round(repeat["repeat_cigar_reads_per_s"], 2)
                      if repeat.get("repeat_cigar_reads_per_s") else None,
                  "repeat_vs_baseline":
                      round(repeat["repeat_reads_per_s"] / base, 2)
                      if (repeat.get("repeat_reads_per_s") and base)
                      else None,
                  "repeat_counters": repeat.get("repeat_counters"),
                  "longread": longread,
                  "cold_start_reads_per_s":
                      cold.get("cold_start_reads_per_s"),
                  "scaling_efficiency_2host": scaling,
                  **device,
                  "baseline_reads_per_s": round(base, 3) if base else None,
                  "baseline_omp_reads_per_s":
                      round(base_omp, 3) if base_omp else None},
    }), flush=True)


def main():
    """Runs the measurement in a child process with a deadline, so a hung
    device call cannot hang the caller; the parent never touches JAX (one
    process per card).  A child that fails or times out makes the bench
    exit non-zero with no result line."""
    if os.environ.get("BIOINFO1_BENCH_CHILD"):
        run_measurement()
        return
    budget_s = int(os.environ.get("BIOINFO1_BENCH_TIMEOUT", "1800"))
    env = dict(os.environ, BIOINFO1_BENCH_CHILD="1")
    try:
        r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, capture_output=True, text=True,
                           timeout=budget_s)
    except subprocess.TimeoutExpired:
        print(f"bench timed out after {budget_s} s", file=sys.stderr)
        sys.exit(1)
    sys.stderr.write(r.stderr)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not lines:
        sys.exit(r.returncode or 1)
    print(lines[-1], flush=True)


if __name__ == "__main__":
    main()
