"""Worker process for the multi-host (multi-process) distributed test.

Each process owns 4 virtual CPU devices; jax.distributed.initialize stitches
them into one 8-device global mesh - a stand-in for a 2-host cluster
(SURVEY.md section 4d).  Reads are fed per-process
(make_array_from_process_local_data = the per-host sharded data loading
pattern); the index is replicated; each process dumps its addressable output
shards for the orchestrating test to merge and compare.

Usage: python distributed_worker.py <coord_port> <pid> <nproc> <outdir>
"""

import os
import sys


def main():
    port, pid, nproc, outdir = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                               process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as ge
    from bioinfo1_tpu.parallel import shard as ps
    from bioinfo1_tpu.pipeline import device_map as dm

    reads, lens, didx, k, w = ge._tiny_problem(batch=16)
    reads = np.asarray(reads)
    lens = np.asarray(lens)

    mesh = Mesh(np.array(jax.devices()), axis_names=("data",))
    data_sh = NamedSharding(mesh, P("data"))
    data_sh2 = NamedSharding(mesh, P("data", None))

    # Per-process (per-host) slice of the global batch.
    per = 16 // nproc
    lo = pid * per
    reads_g = jax.make_array_from_process_local_data(
        data_sh2, reads[lo:lo + per])
    lens_g = jax.make_array_from_process_local_data(data_sh, lens[lo:lo + per])
    didx_g = jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            NamedSharding(mesh, P()), np.asarray(a)), didx)

    step = ps.sharded_map_step(mesh, k=k, w=w, mode=0, budget=256,
                               region_cap=reads.shape[1])
    out = step(reads_g, lens_g, didx_g,
               jnp.int32(1), jnp.int32(-1), jnp.int32(-1))

    local = {}
    for field in ("mapped", "score", "q_begin", "q_end", "t_begin", "t_end"):
        arr = getattr(out, field)
        shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
        local[field] = np.concatenate([np.asarray(s.data) for s in shards])
    np.savez(os.path.join(outdir, f"out_{pid}.npz"), **local)
    print("WORKER_OK", pid, flush=True)


if __name__ == "__main__":
    main()
