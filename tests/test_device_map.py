"""Fused device map step + shard_map distribution vs the host pipeline."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bioinfo1_tpu import reference_model as rm
from bioinfo1_tpu.index import builder
from bioinfo1_tpu.pipeline import device_map as dm
from bioinfo1_tpu.parallel import shard as ps


K, W, F = 11, 5, 0.0


@pytest.fixture(scope="module")
def problem():
    rng = random.Random(99)
    genome = "".join(rng.choice("ACGT") for _ in range(30000))
    index = builder.build_index(genome, K, W, F)
    didx = dm.device_index_from_host(index)
    reads = []
    for i in range(16):
        ln = rng.randrange(200, 900)
        start = rng.randrange(0, len(genome) - ln)
        frag = genome[start:start + ln]
        frag = "".join(c if rng.random() > 0.03 else rng.choice("ACGT")
                       for c in frag)
        if i % 3 == 0:
            frag = rm.reverse_complement(frag)
        reads.append(frag)
    # One junk read that should not map.
    reads.append("".join(rng.choice("ACGT") for _ in range(300)))
    L = 1024
    arr = np.zeros((len(reads), L), dtype=np.uint8)
    lens = np.zeros((len(reads),), dtype=np.int32)
    for i, s in enumerate(reads):
        arr[i, :len(s)] = np.frombuffer(s.encode(), dtype=np.uint8)
        lens[i] = len(s)
    return genome, index, didx, reads, arr, lens


def _spec_map(genome, read, mode_name):
    spec_idx = rm.build_index(genome, K, W, F)
    frag = rm.remove_duplicates(rm.minimize(read, K, W).minimizers)
    mf, mr = rm.find_matches(frag, spec_idx)
    cf, cr = rm.find_lis(mf), rm.find_lis(mr)
    chain = cf if len(cf) >= len(cr) else cr
    if not chain:
        return None
    is_fwd = chain == cf
    q_begin, q_end = chain[0][0] - 1, chain[-1][0] + K - 2
    t_begin, t_end = chain[0][1] - 1, chain[-1][1] + K - 2
    tgt = spec_idx.reference if is_fwd else spec_idx.reference_rc
    res = rm.align(read[q_begin:q_end + 1], tgt[t_begin:t_end + 1],
                   mode_name, 1, -1, -1, want_cigar=False)
    return (is_fwd, q_begin, q_end, t_begin, t_end, res.score)


@pytest.mark.parametrize("mode_name,mode", [("global", 0), ("local", 1),
                                            ("semiGlobal", 2)])
def test_map_step_matches_spec(problem, mode_name, mode):
    genome, index, didx, reads, arr, lens = problem
    out = dm.map_step(jnp.asarray(arr), jnp.asarray(lens), didx,
                      jnp.int32(1), jnp.int32(-1), jnp.int32(-1),
                      k=K, w=W, mode=mode, budget=1024, region_cap=1024)
    out = jax.device_get(out)
    assert not out.overflow.any()
    for i, read in enumerate(reads):
        want = _spec_map(genome, read, mode_name)
        if want is None:
            assert not out.mapped[i]
            continue
        is_fwd, qb, qe, tb, te, score = want
        assert bool(out.mapped[i])
        assert bool(out.is_fwd[i]) == is_fwd, i
        assert (int(out.q_begin[i]), int(out.q_end[i])) == (qb, qe)
        assert (int(out.t_begin[i]), int(out.t_end[i])) == (tb, te)
        assert int(out.score[i]) == score, (i, mode_name)


def test_sharded_step_matches_single(problem):
    genome, index, didx, reads, arr, lens = problem
    n_dev = min(len(jax.devices()), 8)
    if n_dev < 2:
        pytest.skip("needs multiple devices")
    B = (len(reads) // n_dev) * n_dev
    single = dm.map_step(jnp.asarray(arr[:B]), jnp.asarray(lens[:B]), didx,
                         jnp.int32(1), jnp.int32(-1), jnp.int32(-1),
                         k=K, w=W, mode=0, budget=1024, region_cap=1024)
    mesh = ps.make_mesh(n_dev)
    didx_rep = ps.replicate_index(didx, mesh)
    step = ps.sharded_map_step(mesh, k=K, w=W, mode=0, budget=1024,
                               region_cap=1024)
    multi = step(jnp.asarray(arr[:B]), jnp.asarray(lens[:B]), didx_rep,
                 jnp.int32(1), jnp.int32(-1), jnp.int32(-1))
    for field in ("mapped", "is_fwd", "q_begin", "q_end", "t_begin",
                  "t_end", "score"):
        np.testing.assert_array_equal(
            jax.device_get(getattr(single, field)),
            jax.device_get(getattr(multi, field)), err_msg=field)


def test_match_budget_overflow_flag(problem):
    genome, index, didx, reads, arr, lens = problem
    out = dm.map_step(jnp.asarray(arr), jnp.asarray(lens), didx,
                      jnp.int32(1), jnp.int32(-1), jnp.int32(-1),
                      k=K, w=W, mode=0, budget=16, region_cap=1024)
    out = jax.device_get(out)
    assert out.overflow.any()
    assert not out.mapped[out.overflow].any()


def test_map_step_banded_matches_full(problem):
    """The banded fill path (ops/band.fill_banded, with its certificate)
    gives the full-matrix path's mappings and scores."""
    genome, index, didx, reads, arr, lens = problem
    want = dm.map_step(jnp.asarray(arr), jnp.asarray(lens), didx,
                       jnp.int32(1), jnp.int32(-1), jnp.int32(-1),
                       k=K, w=W, mode=0, budget=1024, region_cap=1024)
    got = dm.map_step(jnp.asarray(arr), jnp.asarray(lens), didx,
                      jnp.int32(1), jnp.int32(-1), jnp.int32(-1),
                      k=K, w=W, mode=0, budget=1024, region_cap=1024,
                      band=128)
    assert not jax.device_get(got.inexact).any()
    for field in ("mapped", "is_fwd", "q_begin", "q_end", "t_begin",
                  "t_end", "score"):
        np.testing.assert_array_equal(
            jax.device_get(getattr(want, field)),
            jax.device_get(getattr(got, field)), err_msg=field)


@pytest.mark.parametrize("mode_name", ["global", "local", "semiGlobal"])
def test_map_step_cigar_matches_host_pipeline(problem, mode_name):
    """Fused -c step (banded parents + on-device walk) vs the host pipeline
    in ALL THREE modes: identical PAF lines including CIGARs for every
    mapped read (local/semiGlobal fused -c is new in r03)."""
    genome, index, didx, reads, arr, lens = problem
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    records = [(f"r{i}", s) for i, s in enumerate(reads)]
    cfg = MapperConfig(k=K, w=W, f=F, output_cigar=True,
                       align_type=mode_name)
    fused_m = Mapper([("ref", genome)], cfg)
    assert fused_m._fast_path_ok()
    fused_lines = fused_m.map_records(records)

    host_m = Mapper([("ref", genome)], MapperConfig(k=K, w=W, f=F,
                                                    output_cigar=True,
                                                    align_type=mode_name))
    host_m._fast_path_ok = lambda: False
    host_lines = host_m.map_records(records)
    assert fused_lines == host_lines
    assert any("cg:Z:" in l for l in fused_lines)


def test_map_step_cigar_certificate_fallback(problem):
    """A read whose chain spans far more target than query (certificate
    miss: goal off-band) must still come back correct via the host path."""
    genome, index, didx, reads, arr, lens = problem
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig
    # Query = two distant genome pieces glued: the chain can span them with
    # one huge target gap, pushing the goal cell far off the band.
    frag = genome[1000:1400] + genome[9000:9400]
    records = [("chimera", frag)] + [(f"r{i}", s)
                                     for i, s in enumerate(reads[:4])]
    cfg = MapperConfig(k=K, w=W, f=F, output_cigar=True)
    fused_m = Mapper([("ref", genome)], cfg)
    fused_lines = fused_m.map_records(records)
    host_m = Mapper([("ref", genome)], MapperConfig(k=K, w=W, f=F,
                                                    output_cigar=True))
    host_m._fast_path_ok = lambda: False
    host_lines = host_m.map_records(records)
    assert fused_lines == host_lines


def test_poisoned_batch_fault_isolation(problem, capsys):
    """An unexpected exception in one batch must not abort the run
    (VERDICT r02 item 8; reference analog team_mapper.cpp:663-683):
    a fused-path fault re-routes through the host pipeline (full recovery);
    a host-path fault skips the batch with the reference's stderr line."""
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig
    genome, index, didx, reads, arr, lens = problem
    records = [(f"r{i}", s) for i, s in enumerate(reads[:6])]
    cfg = MapperConfig(k=K, w=W, f=F)

    clean = Mapper([("ref", genome)], cfg).map_records(records)

    # Fused path poisoned -> host path recovers, identical output.
    m1 = Mapper([("ref", genome)], cfg)
    m1._map_bucket_fused = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("poisoned device batch"))
    out1 = m1.map_records(records)
    assert out1 == clean
    assert m1.counters.faults > 0
    assert "Exception during Align" in capsys.readouterr().err

    # Host path ALSO poisoned -> reads skipped, run completes, no output.
    import bioinfo1_tpu.pipeline.mapper as mp
    m2 = Mapper([("ref", genome)], cfg)
    m2._map_bucket_fused = m1._map_bucket_fused
    orig = mp._map_bucket
    mp._map_bucket = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("poisoned host batch"))
    try:
        out2 = m2.map_records(records)
    finally:
        mp._map_bucket = orig
    assert out2 == []
    assert m2.counters.faults >= 2
    assert "Exception during Align" in capsys.readouterr().err


def test_band_ladder_grows_on_big_indel(problem):
    """A 300 bp deletion drifts the goal cell past the initial 256 band:
    the first fused -c pass misses the certificate, the read re-aligns
    through the realign-only pass (host_fallbacks counts the miss), and
    the output still matches the executable spec byte-for-byte."""
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig
    genome, index, didx, reads, arr, lens = problem
    big_del = genome[2000:2800] + genome[3100:3800]   # 1500 q vs 1800 t
    records = [("bigdel", big_del)] + [(f"r{i}", s)
                                       for i, s in enumerate(reads[:4])]
    cfg = MapperConfig(k=K, w=W, f=F, output_cigar=True)
    m = Mapper([("ref", genome)], cfg)
    lines = m.map_records(records)
    assert m.counters.host_fallbacks > 0, m.counters.as_dict()
    # The outlier's needed band folds into the persisted value (capped at
    # 2x p99); it must still reflect the indel drift: wider than the 256
    # default.
    assert max(b for (_, fc), b in m._band_by_key.items() if fc) > 256
    spec = rm.map_all([("ref", genome)], records,
                      rm.MapperParams(k=K, w=W, f=F, output_cigar=True))
    assert lines == spec


def test_pressure_valve_advances_checkpoint(problem):
    """A lone record in a bucket that never fills must not pin the
    checkpoint: once it goes STALE (16 flushes' worth of records arrive
    after it), the valve flushes its bucket so `emitted` advances before
    end-of-input (ADVICE r02), and output is unchanged."""
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig
    genome, index, didx, reads, arr, lens = problem
    rng = random.Random(7)
    lone = genome[5000:5080]                      # its own length bucket
    records = [("lone", lone)]
    for i in range(160):                          # > 16 * flush_size(8)
        start = rng.randrange(0, len(genome) - 500)
        records.append((f"r{i}", genome[start:start + 500]))
    cfg = MapperConfig(k=K, w=W, f=F, batch_size=8)
    m = Mapper([("ref", genome)], cfg)
    progress = []
    lines = []
    for p, ls in m.map_records_iter(records):
        progress.append(p)
        lines.extend(ls)
    # Some yield strictly before the final drain must already be past the
    # lone record (the old code could only reach it at end-of-input).
    assert any(p > 0 for p in progress[:-1]), progress
    assert lines == m.map_records(records)


def test_extract_flat_windows_edge():
    """A window whose END overruns the source must read zeros past the end
    WITHOUT shifting its start (ADVICE r02: the old n-cap start clamp filled
    valid lanes with bytes from before `begin` for reads whose region ends
    within `cap` of the padded reference edge)."""
    src = jnp.arange(1, 129, dtype=jnp.uint8)          # n = 128
    got = np.asarray(dm._extract_flat_windows(src, jnp.array([120, 0, 128]),
                                              16))
    np.testing.assert_array_equal(
        got[0], np.concatenate([np.arange(121, 129), np.zeros(8)]))
    np.testing.assert_array_equal(got[1], np.arange(1, 17))
    np.testing.assert_array_equal(got[2], np.zeros(16))   # fully past the end
    # Source shorter than cap (tiny test genomes): all-padding, no wrap.
    tiny = np.asarray(dm._extract_flat_windows(
        jnp.arange(1, 9, dtype=jnp.uint8), jnp.array([0, 4]), 16))
    np.testing.assert_array_equal(
        tiny[0], np.concatenate([np.arange(1, 9), np.zeros(8)]))
    np.testing.assert_array_equal(
        tiny[1], np.concatenate([np.arange(5, 9), np.zeros(12)]))


def test_direct_index_override_guard(problem, monkeypatch):
    """BIOINFO1_DIRECT_INDEX=1 with 2k > 30 hash bits must raise, not
    attempt a 2^(2k)-entry directory (ADVICE r02)."""
    genome, index, didx, reads, arr, lens = problem
    monkeypatch.setenv("BIOINFO1_DIRECT_INDEX", "1")
    big_k = dataclasses_replace_k(index, 16)
    with pytest.raises(ValueError, match="DIRECT_INDEX"):
        dm.device_index_from_host(big_k)


def dataclasses_replace_k(index, k):
    import dataclasses as _dc
    return _dc.replace(index, k=k)


def test_direct_index_mode_matches(problem, monkeypatch):
    """Direct-address directory (steps=0) vs the bucketed binary search:
    identical mapping output on the same index."""
    genome, index, didx, reads, arr, lens = problem
    monkeypatch.setenv("BIOINFO1_DIRECT_INDEX", "1")
    ddx = dm.device_index_from_host(index)
    assert ddx.bsearch_steps == 0
    assert ddx.bucket_off.shape[0] == (1 << (2 * K)) + 1
    args = (jnp.asarray(arr), jnp.asarray(lens))
    scoring = (jnp.int32(1), jnp.int32(-1), jnp.int32(-1))
    a = jax.device_get(dm.map_step(*args, didx, *scoring, k=K, w=W,
                                   mode=0, budget=1024, region_cap=1024))
    b = jax.device_get(dm.map_step(*args, ddx, *scoring, k=K, w=W,
                                   mode=0, budget=1024, region_cap=1024))
    for f in ("mapped", "is_fwd", "q_begin", "q_end", "t_begin", "t_end",
              "score", "overflow"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
