"""CLI extensions: -o file output, --resume checkpointing, index save/load,
gzip ingestion."""

import gzip
import io
import json
import os

from bioinfo1_tpu import cli
from bioinfo1_tpu.io import fastx


def run_ours(args):
    out = io.StringIO()
    err = io.StringIO()
    rc = cli.main(args, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


def _write_inputs(tmp_path):
    ref = tmp_path / "ref.fasta"
    reads = tmp_path / "reads.fasta"
    genome = "ACGTACGTACGTACGTACGTACGTACGTACGTACGTACGT"
    ref.write_text(f">ref\n{genome}\n")
    reads.write_text(">r1\nACGTACGTACGTACGTACGTACGT\n"
                     ">r2\nGTACGTACGTACGTACGTACG\n"
                     ">r3\nCGTACGTACGTACGTACGTAC\n")
    return str(ref), str(reads)


def test_output_file_and_progress(tmp_path):
    ref, reads = _write_inputs(tmp_path)
    out_path = str(tmp_path / "out.paf")
    rc, stdout, _ = run_ours(["-k", "5", "-w", "2", "--batch-size", "1",
                              "-o", out_path, ref, reads])
    assert rc == 0
    assert stdout == ""                       # rows went to the file
    lines = open(out_path).read().splitlines()
    assert len(lines) == 3
    prog = json.load(open(out_path + ".progress"))
    assert prog["completed_reads"] == prog["total_reads"] == 3
    assert prog["part_bytes"] == os.path.getsize(out_path)


def test_resume_appends_missing_reads(tmp_path):
    ref, reads = _write_inputs(tmp_path)
    full = str(tmp_path / "full.paf")
    run_ours(["-k", "5", "-w", "2", "--batch-size", "1", "-o", full,
              ref, reads])
    want = open(full).read()

    part = str(tmp_path / "part.paf")
    with open(part, "w") as fh:
        fh.write(want.splitlines(keepends=True)[0])
    json.dump({"completed_reads": 1, "total_reads": 3},
              open(part + ".progress", "w"))
    rc, _, _ = run_ours(["-k", "5", "-w", "2", "--batch-size", "1",
                         "-o", part, "--resume", ref, reads])
    assert rc == 0
    assert open(part).read() == want


def test_resume_truncates_uncheckpointed_tail(tmp_path):
    """Crash-window correctness (ADVICE r03): output lines flushed AFTER the
    last progress update (including a torn partial line) must be truncated
    on --resume, not duplicated by the append."""
    ref, reads = _write_inputs(tmp_path)
    full = str(tmp_path / "full.paf")
    run_ours(["-k", "5", "-w", "2", "--batch-size", "1", "-o", full,
              ref, reads])
    want = open(full).read()
    rows = want.splitlines(keepends=True)

    part = str(tmp_path / "part.paf")
    with open(part, "w") as fh:
        fh.write(rows[0])
        checkpointed_bytes = fh.tell()
        fh.write(rows[1][: len(rows[1]) // 2])   # torn line past checkpoint
    json.dump({"completed_reads": 1, "total_reads": 3,
               "part_bytes": checkpointed_bytes},
              open(part + ".progress", "w"))
    rc, _, _ = run_ours(["-k", "5", "-w", "2", "--batch-size", "1",
                         "-o", part, "--resume", ref, reads])
    assert rc == 0
    assert open(part).read() == want


def test_index_save_load_roundtrip(tmp_path):
    ref, reads = _write_inputs(tmp_path)
    idx_path = str(tmp_path / "index.npz")
    rc1, out1, _ = run_ours(["-k", "5", "-w", "2",
                             "--save-index", idx_path, ref, reads])
    rc2, out2, _ = run_ours(["-k", "5", "-w", "2",
                             "--load-index", idx_path, ref, reads])
    assert rc1 == rc2 == 0
    assert out1 == out2
    assert os.path.exists(idx_path)


def test_index_load_preserves_stats(tmp_path):
    """--load-index + -s must print the same index-statistics block as a
    fresh build (regression: top_surviving was lost on load)."""
    ref, reads = _write_inputs(tmp_path)
    idx_path = str(tmp_path / "index.npz")
    rc1, out1, _ = run_ours(["-k", "5", "-w", "2", "-s",
                             "--save-index", idx_path, ref, reads])
    rc2, out2, _ = run_ours(["-k", "5", "-w", "2", "-s",
                             "--load-index", idx_path, ref, reads])
    assert rc1 == rc2 == 0
    assert out1 == out2
    assert "max value" in out1        # the top-surviving line is present


def test_f_flag_atof_semantics(tmp_path):
    """-f with a non-numeric arg parses as 0.0 (std::atof), not a crash."""
    ref, reads = _write_inputs(tmp_path)
    rc_bad, out_bad, _ = run_ours(["-k", "5", "-w", "2", "-f", "bogus",
                                   ref, reads])
    rc_zero, out_zero, _ = run_ours(["-k", "5", "-w", "2", "-f", "0",
                                     ref, reads])
    assert rc_bad == rc_zero == 0
    assert out_bad == out_zero


def test_atof_unit():
    from bioinfo1_tpu.cli import _atof
    assert _atof("0.001") == 0.001
    assert _atof("  1.5e3x") == 1500.0
    assert _atof("abc") == 0.0
    assert _atof("") == 0.0
    assert _atof(".5") == 0.5
    assert _atof("-2") == -2.0


def test_streaming_matches_materialized(tmp_path):
    """-o (streaming ingestion) rows == stdout (materialized) rows, for
    FASTA and FASTQ, including gzip."""
    ref, reads = _write_inputs(tmp_path)
    fq = tmp_path / "reads.fastq"
    recs = fastx.parse_fasta(reads)
    with open(fq, "w") as fh:
        for name, seq in recs:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    for reads_file in (reads, str(fq)):
        rc1, stdout, _ = run_ours(["-k", "5", "-w", "2", ref, reads_file])
        out_path = str(tmp_path / "stream.paf")
        rc2, _, _ = run_ours(["-k", "5", "-w", "2", "-o", out_path,
                              ref, reads_file])
        assert rc1 == rc2 == 0
        assert open(out_path).read().splitlines() == stdout.splitlines()
        prog = json.load(open(out_path + ".progress"))
        assert prog["completed_reads"] == prog["total_reads"] == 3


def test_stream_reads_chunking(tmp_path):
    """stream_reads yields multiple batches under a small chunk budget and
    concatenates to the same records as the whole-file parser."""
    reads = tmp_path / "many.fasta"
    with open(reads, "w") as fh:
        for i in range(20):
            fh.write(f">r{i}\n{'ACGT' * 25}\n")
    stream = fastx.stream_reads(str(reads), chunk_bases=250)
    batches = list(stream.batches)
    assert not stream.is_fastq
    assert len(batches) > 3
    flat = [r for b in batches for r in b]
    assert flat == fastx.parse_fasta(str(reads))


def test_gzip_reads_ingestion(tmp_path):
    ref, reads = _write_inputs(tmp_path)
    gz = str(tmp_path / "reads.fasta.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(open(reads, "rb").read())
    rc_plain, out_plain, _ = run_ours(["-k", "5", "-w", "2", ref, reads])
    rc_gz, out_gz, _ = run_ours(["-k", "5", "-w", "2", ref, gz])
    assert rc_plain == rc_gz == 0
    assert out_plain == out_gz


def test_gzip_fastq_sniffing(tmp_path):
    gz = str(tmp_path / "reads.fastq.gz")
    with gzip.open(gz, "wb") as fh:
        fh.write(b"@r1\nACGTACGT\n+\nIIIIIIII\n")
    sniffed = fastx.parse_reads(gz)
    assert sniffed.is_fastq
    assert sniffed.records == [("r1", "ACGTACGT")]


def test_repeat_genome_budget_retry(tmp_path):
    """A repeat-dense genome overflows small match budgets; the retry loop
    must converge to the same output a generous budget produces (exercises
    the fused path's overflow -> doubled-budget -> host-fallback ladder)."""
    import random
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    rng = random.Random(5)
    unit = "".join(rng.choice("ACGT") for _ in range(400))
    spacer = lambda: "".join(rng.choice("ACGT") for _ in range(300))
    genome = "".join(unit + spacer() for _ in range(12))
    reads = []
    for i in range(6):
        start = rng.randrange(0, len(genome) - 700)
        frag = genome[start:start + 700]
        frag = "".join(c if rng.random() > 0.02 else rng.choice("ACGT")
                       for c in frag)
        reads.append((f"r{i}", frag))

    base = MapperConfig(k=11, w=3, f=0.0)
    tiny = MapperConfig(k=11, w=3, f=0.0, initial_match_budget=8)
    want = Mapper([("ref", genome)], base).map_records(reads)
    got = Mapper([("ref", genome)], tiny).map_records(reads)
    assert want == got
    assert any("\t" in l for l in want)      # something actually mapped


def test_crash_mid_run_resume_identical(tmp_path):
    """Fault injection: kill the mapper mid-run (SIGKILL), then --resume.
    The resumed output must be byte-identical to an uninterrupted run -
    the checkpoint only ever records the contiguous completed prefix."""
    import random
    import signal
    import subprocess
    import sys
    import time

    rng = random.Random(3)
    genome = "".join(rng.choice("ACGT") for _ in range(20000))
    ref = tmp_path / "ref.fasta"
    ref.write_text(f">ref\n{genome}\n")
    reads = tmp_path / "reads.fasta"
    with open(reads, "w") as fh:
        for i in range(30):
            start = rng.randrange(0, len(genome) - 400)
            fh.write(f">r{i}\n{genome[start:start + 400]}\n")

    env = dict(os.environ, BIOINFO1_PLATFORM="cpu")
    base = [sys.executable, "-m", "bioinfo1_tpu.cli", "-k", "11", "-w", "3",
            "--batch-size", "4", str(ref), str(reads)]
    full = tmp_path / "full.paf"
    subprocess.run(base[:2] + base[2:-2] + ["-o", str(full)] + base[-2:],
                   env=env, check=True, timeout=600,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
    want = full.read_text()

    part = tmp_path / "part.paf"
    cmd = base[:2] + base[2:-2] + ["-o", str(part)] + base[-2:]
    repo = os.path.dirname(os.path.dirname(__file__))
    proc = subprocess.Popen(cmd, env=env, cwd=repo)
    # Kill as soon as SOME progress is checkpointed but before completion.
    deadline = time.time() + 300
    killed = False
    prog = str(part) + ".progress"
    while time.time() < deadline:
        if os.path.exists(prog):
            done = json.load(open(prog)).get("completed_reads", 0)
            if 0 < done < 30:
                proc.send_signal(signal.SIGKILL)
                killed = True
                break
            if done >= 30:
                break          # finished before we could kill - still fine
        time.sleep(0.02)
    proc.wait(timeout=600)

    rc = subprocess.run(cmd + ["--resume"], env=env, timeout=600,
                        cwd=repo).returncode
    assert rc == 0
    assert part.read_text() == want, f"killed={killed}"


def test_cert_miss_realign_parity():
    """Reads with a large structural indel drift past the default band, so
    the first fused -c pass misses the strict certificate and the
    realign-only pass (mapper._realign_bucket, r05) re-aligns them at the
    proven band reusing the failed pass's chain coordinates.  Output must
    match the reference model exactly, and the realign path must actually
    run (host_fallbacks > 0)."""
    import numpy as np
    from bioinfo1_tpu import reference_model as rm
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(9)
    bases = np.frombuffer(b"CATG", np.uint8)
    genome = bases[rng.integers(0, 4, 60000)]
    gstr = genome.tobytes().decode("latin1")
    records = []
    for i in range(6):
        start = int(rng.integers(0, len(genome) - 2000))
        r = list(genome[start:start + 1500])
        # 600 bp deletion mid-read: the optimal path drifts ~600 off the
        # main diagonal, past the default 256 starting band.
        del r[700:1300]
        records.append((f"sv{i}", bytes(r).decode("latin1")))
        records.append((f"pt{i}",
                        genome[start:start + 1200].tobytes()
                        .decode("latin1")))
    cfg = MapperConfig(output_cigar=True)
    mapper = Mapper([("ref", gstr)], cfg)
    got = mapper.map_records(records)
    want = rm.map_all([("ref", gstr)], records,
                      rm.MapperParams(output_cigar=True))
    assert got == want
    assert mapper.counters.host_fallbacks > 0, (
        "expected cert misses routed through the realign pass")


def test_pathological_repeat_budget_convergence():
    """VERDICT r04 item 10: an (almost) all-repeat genome multiplies every
    minimizer's hit count; the budget-boost ladder plus per-read doubling
    must converge every read well before the 24-attempt safety valve
    (mapper.map_batch) gives up, and reads must still map."""
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"CATG", np.uint8)
    # 12 near-identical copies of a 1.2 kb unit, each separated by > 5 kb
    # of random sequence: a read inside a copy sees ~12 hits per minimizer
    # (several boost doublings past the default budget), but the 5000-gap
    # LIS cap keeps chains from spanning copies (adjacent copies would
    # chain into multi-copy mega-regions and route to the slow host path,
    # which is not what this test exercises).
    unit = bases[rng.integers(0, 4, 1200)]
    parts = []
    starts = []
    off = 0
    for _ in range(12):
        c = unit.copy()
        pos = rng.integers(0, len(c), 8)
        c[pos] = bases[rng.integers(0, 4, len(pos))]
        starts.append(off)
        parts.append(c)
        off += len(c)
        spacer = bases[rng.integers(0, 4, 5200)]
        parts.append(spacer)
        off += len(spacer)
    genome = np.concatenate(parts)
    gstr = genome.tobytes().decode("latin1")
    records = []
    for i in range(8):
        s0 = starts[int(rng.integers(0, len(starts)))]
        records.append((f"r{i}",
                        genome[s0:s0 + 900].tobytes().decode("latin1")))
    mapper = Mapper([("ref", gstr)], MapperConfig())
    lines = mapper.map_records(records)
    assert len(lines) == len(records), "pathological repeats must still map"
    c = mapper.counters
    # Convergence evidence: the boost ladder plus per-read doubling settled
    # within a handful of retries - nowhere near the 24-attempt valve
    # (which would surface as reads silently dropped, caught above).
    assert c.budget_retries <= 4 * len(records)
    # Second pass: the persisted boost should start wide enough that
    # budget retries stop entirely.
    mapper.counters = type(c)()
    mapper.map_records(records)
    assert mapper.counters.budget_retries == 0


def test_budget_jump_no_overshoot():
    """r05 regression: when the observed need only slightly exceeds the
    bucket's base budget, the boost ladder and the per-read jump must move
    to the NEXT power of two (2x), not the _pow2_at_least default floor
    (8x) - and the two multipliers must combine by max, not product.  The
    8x8=64x overshoot compiled and ran chain DPs ~64x wider than needed
    (a CPU suite hang traced to it)."""
    import numpy as np
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(23)
    genome = "".join("CATG"[i] for i in rng.integers(0, 4, 40000))
    records = []
    for r in range(16):
        start = int(rng.integers(0, 38500))
        records.append((f"r{r}", genome[start:start + 1200]))
    # k=9/w=3 on 1.2 kb reads: per-read match totals land ~15% above the
    # 3L/8 base budget, so every read overflows the first pass by a hair.
    mapper = Mapper([("ref", genome)], MapperConfig(k=9, w=3))
    lines = mapper.map_records(records)
    assert len(lines) == len(records)
    boost = mapper._budget_boost.get(1536, 1)
    assert boost <= 2, f"boost overshot: {boost} (need was ~1.15x base)"
    # Second pass at the persisted boost: no retries at all.
    mapper.counters = type(mapper.counters)()
    mapper.map_records(records)
    assert mapper.counters.budget_retries == 0
