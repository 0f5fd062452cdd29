"""Worker for the multi-host scaling-efficiency measurement.

One process == one simulated host: pinned to a single CPU core by the
orchestrator (tools/measure_scaling.py), one virtual XLA CPU device,
running the PRODUCT path end to end with per-stage timing (VERDICT r03
item 6): sliced FASTA parse (io/fastx.parse_reads_slice - the real
multi-host ingestion), Mapper mapping, and the liveness-aware
MergeSession gather to process 0.

Usage: python tools/scaling_worker.py <port> <pid> <nproc> <reads.fasta>
       <out.json>
(port 0 => single-process mode, no jax.distributed)
"""

import json
import os
import sys
import time


def main():
    port, pid, nproc, reads_path, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
        sys.argv[4], sys.argv[5])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from bioinfo1_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache(0.0)
    if nproc > 1:
        # Env form so parallel.shard._merge_endpoint derives the p2p merge
        # port from the same coordinator address.
        os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                                   process_id=pid)

    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bioinfo1_tpu.io import fastx
    from bioinfo1_tpu.parallel import shard as ps
    from bioinfo1_tpu.pipeline.mapper import Mapper, MapperConfig

    rng = np.random.default_rng(42)
    genome = "".join("CATG"[i] for i in rng.integers(0, 4, 200_000))

    cfg = MapperConfig(batch_size=64, devices=1)
    mapper = Mapper([("ref", genome)], cfg)

    # Stage 1: sliced parse (each host materializes only its record slice,
    # like the CLI's multi-host ingestion path).
    t0 = time.perf_counter()
    if nproc > 1:
        _, total = fastx.parse_reads_slice(reads_path, 0, 0)
        lo, hi = ps.process_read_slice(total)
        reads, _ = fastx.parse_reads_slice(reads_path, lo, hi)
    else:
        reads = fastx.parse_reads(reads_path)
        total = len(reads.records)
    parse_s = time.perf_counter() - t0
    local = reads.records

    # Warm-up: compile every bucket shape (shared persistent cache).
    mapper.map_records(local[: cfg.batch_size])

    # Median of 3 timed repetitions (min overstates scaling when one rep
    # benefits from a quiet machine; median damps OS scheduling noise both
    # ways).  Barrier before each so processes start together.
    map_ts, merge_ts = [], []
    merged = None
    for rep in range(3):
        if nproc > 1:
            # One-shot channel per rep, each on its OWN port: reusing a
            # port races a new sender against the previous session's
            # still-open reader threads.  Created before the barrier so
            # the early-connect overlaps the map stage like the CLI's.
            os.environ["BIOINFO1_MERGE_PORT"] = str(port + 101 + rep)
            merge = ps.MergeSession()
            from jax.experimental import multihost_utils as mhu
            mhu.process_allgather(np.int32(pid))
        t0 = time.perf_counter()
        lines = mapper.map_records(local)
        t1 = time.perf_counter()
        merged = merge.gather(lines) if nproc > 1 else list(lines)
        merge_ts.append(time.perf_counter() - t1)
        map_ts.append(t1 - t0)

    map_s = sorted(map_ts)[1]
    merge_s = sorted(merge_ts)[1]
    if pid == 0:
        assert merged is not None and len(merged) >= total * 9 // 10, \
            f"only {len(merged)} of {total} reads mapped"
        with open(out_path, "w") as fh:
            json.dump({"nproc": nproc, "n_reads": total,
                       "parse_s": parse_s, "map_only_s": map_s,
                       "merge_s": merge_s,
                       "map_s": map_s + merge_s,
                       "reads_per_s": total / (map_s + merge_s),
                       "mapped": len(merged)}, fh)
    print("WORKER_OK", pid, flush=True)


if __name__ == "__main__":
    main()
