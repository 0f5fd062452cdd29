#!/usr/bin/env python
"""Smoke test of the mapper's main path on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # four cards: phase 1 and the mesh

One process drives the card; its only child is ``nvidia-smi``.  Phases:

1. Identity: the card's name and power limit, the JAX version and devices,
   and whether the native host library loaded.  Fails unless JAX's
   platform is ``gpu``.
2. Kernel parity at real widths: the CUDA band-fill kernel against its lax
   twin at the benchmark's shapes, all three modes, score-only and with
   parents, dash_free on and off; exact equality.  The lowered score and
   -c steps must call the kernel.
3. The main path at E. coli scale: the CLI (``cli.main``, in process) maps
   ONT-indel reads against a 4,641,652 bp genome score-only and with -c;
   no batch may fault, >= 90% of reads map, and both runs agree on every
   score.
4. Parity with the executable spec: the CLI's -c PAF under each alignment
   mode is byte-equal to reference_model.map_all on a 200 kb genome.

``--four-cards`` runs phase 1 and then maps the phase-3 reads with
``--devices 4`` (index replicated, then hash-range sharded), score-only
and -c, each compared byte for byte with ``--devices 1``.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; any failure exits
non-zero without it.
"""

import argparse
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Benchmark shapes (reads per batch, read bucket width, target region cap,
# band): (i) the 4 kb score-only headline, (ii) 8 kb -c batches, (iii) a
# wide realign band, (iv) 20 kb reads.
PARITY_SHAPES = {
    "i": (256, 4096, 8192, 128),
    "ii-512": (512, 8192, 16384, 256),
    "ii-384": (384, 8192, 16384, 256),
    "iii": (32, 8192, 16384, 2048),
    "iv": (64, 24576, 49152, 512),
}


def log(*args):
    print(*args, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def card_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}")
    check(r.returncode == 0 and r.stdout.strip(), "nvidia-smi failed")
    return r.stdout.strip()


def phase_identity(jax):
    from bioinfo1_tpu import native
    card = card_line()
    log(card)
    log("jax", jax.__version__, jax.devices())
    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX platform is {dev.platform}, not gpu")
    log("native host library loaded:", native.get_lib() is not None)
    return card


def phase_kernel_parity(jax):
    import numpy as np
    from bioinfo1_tpu.ops import band
    from bioinfo1_tpu.pipeline import device_map as dm
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(2)
    prm = np.array([1, -1, -1], np.int32)
    cases = [("dash", 8, 300, 600, 128)]
    cases += [(name,) + shape for name, shape in PARITY_SHAPES.items()]
    for name, B, n, m, W in cases:
        q, ql, t, tl = sim.region_pairs(rng, B, n, m)
        dash_free = (True, False)
        if name == "dash":
            q[0, 3] = t[1, 5] = 45            # literal '-' bytes
            dash_free = (False,)
        for mode in (0, 1, 2):
            for want_parents in (False, True):
                t0 = time.perf_counter()
                bad = band.parity_mismatches(
                    q, ql, t, tl, prm, band=W, mode=mode,
                    want_parents=want_parents, dash_free=dash_free)
                log(f"parity {name} B={B} n={n} m={m} W={W} mode={mode} "
                    f"parents={want_parents}: "
                    f"{'ok' if not bad else bad} "
                    f"({time.perf_counter() - t0:.1f} s)")
                check(not bad, f"kernel != twin at {name} mode {mode}")
        gc.collect()
    found = dm.kernel_in_lowered_steps()
    log("kernel custom call in lowered map_step / map_step_cigar:", found)
    check(all(found), "a lowered step does not call the kernel")


def write_fasta(path, records):
    with open(path, "w") as fh:
        for name, seq in records:
            fh.write(f">{name}\n{seq}\n")


def run_cli(argv, env=None):
    """cli.main in this process; returns (stdout, stderr, seconds)."""
    from bioinfo1_tpu import cli
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv, stdout=out, stderr=err)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.collect()
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)} returned {rc}: "
          f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), dt


def counters_of(stderr):
    """The --profile counters: the last JSON object on stderr."""
    for line in reversed(stderr.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise SmokeFailure("no --profile counters on stderr")


def ecoli_inputs(tmp):
    import numpy as np
    import bench
    from bioinfo1_tpu.utils import simulate as sim

    genome = bench.make_data()[0]
    rng = np.random.default_rng(bench.SEED + 11)
    reads = sim.simulate_reads(genome, [2000, 4000, 8000] * 512, rng)
    reads += sim.simulate_reads(genome, [20000] * 64, rng)
    reads = [(f"r{i}", s) for i, (_, s) in enumerate(reads)]
    ref = os.path.join(tmp, "ecoli.fasta")
    fq = os.path.join(tmp, "ont.fasta")
    write_fasta(ref, [("ecoli", genome.tobytes().decode("latin1"))])
    write_fasta(fq, reads)
    return ref, fq, reads


def scores_of(paf):
    return {ln.split("\t")[0]: int(ln.split("\t")[9])
            for ln in paf.splitlines() if ln}


def phase_main_path(jax, tmp, card):
    ref, fq, reads = ecoli_inputs(tmp)
    n = len(reads)
    scores = {}
    for label, extra in (("score-only", []), ("-c", ["-c"])):
        paf, err, dt = run_cli(["--devices", "1", "--profile"] + extra
                               + [ref, fq])
        c = counters_of(err)
        mapped = len([ln for ln in paf.splitlines() if ln])
        log(f"main path {label}: {n} reads in {dt:.3f} s wall (index build "
            f"and compiles included): {n / dt:.2f} reads/s; mapped "
            f"{mapped}; faults {c['faults']}; host_fallbacks "
            f"{c['host_fallbacks']}; t_host_s {c['t_host_s']}; "
            f"cert_hit_rate {c.get('cert_hit_rate')} [{card}]")
        check(c["faults"] == 0, f"{label}: {c['faults']} faulted batches")
        check(mapped >= 0.9 * n, f"{label}: only {mapped}/{n} reads mapped")
        scores[label] = scores_of(paf)
    check(scores["score-only"] == scores["-c"],
          "score-only and -c runs disagree on scores")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak device memory {stats.get('peak_bytes_in_use')} of "
        f"{stats.get('bytes_limit')} bytes [{card}]")
    return ref, fq


def phase_spec_parity(tmp):
    import numpy as np
    from bioinfo1_tpu import reference_model as rm
    from bioinfo1_tpu.utils import simulate as sim

    rng = np.random.default_rng(7)
    genome = sim.random_genome(200_000, rng)
    lengths = list(rng.integers(1000, 8001, 24))
    reads = [(f"s{i}", s) for i, (_, s) in
             enumerate(sim.simulate_reads(genome, lengths, rng))]
    ref_rec = [("small", genome.tobytes().decode("latin1"))]
    ref = os.path.join(tmp, "small.fasta")
    fq = os.path.join(tmp, "small_reads.fasta")
    write_fasta(ref, ref_rec)
    write_fasta(fq, reads)
    for mode in ("global", "local", "semiGlobal"):
        paf, _, dt = run_cli(["--devices", "1", "-c", "-a", mode, ref, fq])
        want = rm.map_all(ref_rec, reads, rm.MapperParams(
            align_type=mode, output_cigar=True))
        got = [ln for ln in paf.splitlines() if ln]
        log(f"spec parity -a {mode}: {len(got)} PAF lines, "
            f"{'byte-equal' if got == want else 'DIFFERENT'} ({dt:.1f} s)")
        check(got == want, f"-a {mode} PAF differs from the executable spec")


def phase_four_cards(jax, tmp, card):
    check(len(jax.devices()) >= 4, f"needs 4 devices, has {jax.devices()}")
    ref, fq, reads = ecoli_inputs(tmp)
    for label, extra in (("score-only", []), ("-c", ["-c"])):
        one, _, dt1 = run_cli(["--devices", "1"] + extra + [ref, fq])
        log(f"{label} --devices 1: {len(reads) / dt1:.2f} reads/s wall "
            f"[{card}]")
        for shard in ("0", "1"):
            four, err, dt4 = run_cli(
                ["--devices", "4", "--profile"] + extra + [ref, fq],
                env={"BIOINFO1_INDEX_SHARD": shard})
            c = counters_of(err)
            same = four == one
            log(f"{label} --devices 4 index {'sharded' if shard == '1' else 'replicated'}: "
                f"{len(reads) / dt4:.2f} reads/s wall, faults {c['faults']}, "
                f"PAF {'byte-equal' if same else 'DIFFERENT'} to --devices 1")
            check(c["faults"] == 0, f"{label} shard={shard}: faults")
            check(same, f"{label} shard={shard}: PAF differs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the four-card mesh phase instead of 2-4")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "bioinfo1_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from bioinfo1_tpu.utils.runtime import configure_jax
    configure_jax()
    import jax

    t_start = time.perf_counter()
    try:
        card = phase_identity(jax)
        with tempfile.TemporaryDirectory() as tmp:
            if args.four_cards:
                phase_four_cards(jax, tmp, card)
            else:
                for name, fn, fargs in (
                        ("kernel parity", phase_kernel_parity, (jax,)),
                        ("main path", phase_main_path, (jax, tmp, card)),
                        ("spec parity", phase_spec_parity, (tmp,))):
                    t0 = time.perf_counter()
                    fn(*fargs)
                    log(f"phase {name} passed in "
                        f"{time.perf_counter() - t0:.1f} s")
    except SmokeFailure as e:
        print(f"chip smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": 4 if args.four_cards else len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
