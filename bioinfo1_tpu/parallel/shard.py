"""Multi-chip distribution of the fused map step.

The reference's only parallelism is an OpenMP parallel-for over reads with a
shared read-only index and a critical-section stdout merge
(team_mapper.cpp:596,685).  The device equivalent (SURVEY.md 2.2):

  * data parallelism over the read batch axis via `shard_map` on a 1-D
    `Mesh` ("data"), reads sharded, index REPLICATED per device,
  * no cross-device communication inside the step (reads are embarrassingly
    parallel); the gather of per-read outputs back to the host replaces the
    `omp critical` merge and is deterministic by construction,
  * multi-host: `jax.distributed.initialize` + per-host read sharding feeds
    the same function; outputs are fetched per host and merged in input
    order (process_allgather when a single writer is wanted).

`shard_map` (not pjit auto-sharding) is used so the per-device code is
explicitly local: XLA cannot accidentally insert collectives into the hot
loop; the only collective cost is the initial index broadcast.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bioinfo1_tpu.pipeline import device_map as dm


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over the first n (default: all) devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), axis_names=("data",))


def auto_mesh(max_devices: int = 0) -> Optional[Mesh]:
    """Product-path mesh: the largest power-of-two prefix of the LOCAL
    devices (pow-2 so the pipeline's canonical pow-2 batch padding is always
    divisible by the mesh).  None when only one device is usable - the
    single-device step needs no shard_map wrapper.

    ``max_devices`` > 0 caps the mesh (the CLI's --devices flag).
    """
    n = jax.local_device_count()
    if max_devices > 0:
        n = min(n, max_devices)
    p = 1
    while p * 2 <= n:
        p *= 2
    if p <= 1:
        return None
    import numpy as np
    return Mesh(np.array(jax.local_devices()[:p]), axis_names=("data",))


def replicate_index(index: dm.DeviceIndex, mesh: Mesh) -> dm.DeviceIndex:
    """Broadcast the index to every device (one-time transfer cost)."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda a: jax.device_put(a, rep), index)


def _index_specs(index: dm.DeviceIndex):
    """Per-leaf PartitionSpecs for a DeviceIndex: hash-range-sharded lookup
    arrays carry a leading device axis (shard_range > 0); ref stays
    replicated."""
    if not index.shard_range:
        return jax.tree.map(lambda _: P(), index)
    return dm.DeviceIndex(
        key_hash=P("data", None), key_pos=P("data", None),
        cnt_fr=P("data", None), cnt_r2=P("data", None),
        bucket_off=P("data", None), ref_bytes=P(), ref_len=P(),
        shard_range=index.shard_range, shift=index.shift,
        bsearch_steps=index.bsearch_steps, cnt_shift=index.cnt_shift)


def shard_index(index: dm.DeviceIndex, mesh: Mesh) -> dm.DeviceIndex:
    """Place a sharded-layout index (sharded_device_index_from_host) so
    device d holds only its hash-range slice - per-device lookup HBM is
    1/mesh.size of the replicated footprint (the BASELINE north star's
    'sharded across a multi-host pod when large')."""
    assert index.shard_range, "pack with sharded_device_index_from_host"
    specs = _index_specs(index)
    return jax.tree.map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        index, specs)


def sharded_map_step(mesh: Mesh, k: int, w: int, mode: int,
                     budget: int = 512, region_cap: int = 0,
                     band: int = 0,
                     oob_end_windows: bool = False,
                     index_specs=None, dash_free: bool = False):
    """Build a jitted data-parallel map step bound to ``mesh``.

    Returns fn(reads (B,L), lens (B,), index, match, mismatch, gap) with B a
    multiple of mesh size; reads/lens sharded on the batch axis, index
    replicated - or hash-range SHARDED when ``index_specs`` (from
    _index_specs on a sharded-layout index) says so - and outputs sharded
    back (fetch with jax.device_get).
    """
    shard_map = jax.shard_map
    sharded = (index_specs is not None
               and getattr(index_specs, "shard_range", 0))
    axis = "data" if sharded else None

    def local_step(reads, lens, index, match, mismatch, gap):
        return dm.map_step(reads, lens, index, match, mismatch, gap,
                           k=k, w=w, mode=mode, budget=budget,
                           region_cap=region_cap,
                           band=band, oob_end_windows=oob_end_windows,
                           shard_axis=axis, dash_free=dash_free)

    ispec = index_specs if index_specs is not None else P()
    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data", None), P("data"), ispec, P(), P(), P()),
        out_specs=jax.tree.map(lambda _: P("data"), dm.MapOut(
            mapped=0, is_fwd=0, q_begin=0, q_end=0, t_begin=0, t_end=0,
            score=0, overflow=0, need=0, inexact=0)),
        check_vma=False)
    return jax.jit(fn)


def sharded_map_step_cigar(mesh: Mesh, k: int, w: int, mode: int,
                           budget: int = 512, region_cap: int = 0,
                           band: int = 256,
                           oob_end_windows: bool = False,
                           index_specs=None, dash_free: bool = False):
    """Data-parallel fused -c step (map_step_cigar over ``mesh``).

    Same contract as sharded_map_step (incl. sharded-index support via
    ``index_specs``); the (steps, B) op-code tensor is sharded on its
    BATCH axis (axis 1).
    """
    shard_map = jax.shard_map
    sharded = (index_specs is not None
               and getattr(index_specs, "shard_range", 0))
    axis = "data" if sharded else None

    def local_step(reads, lens, index, match, mismatch, gap):
        return dm.map_step_cigar(reads, lens, index, match, mismatch, gap,
                                 k=k, w=w, mode=mode, budget=budget,
                                 region_cap=region_cap,
                                 band=band, oob_end_windows=oob_end_windows,
                                 shard_axis=axis, dash_free=dash_free)

    out_specs = dm.CigarOut(
        base=jax.tree.map(lambda _: P("data"), dm.MapOut(
            mapped=0, is_fwd=0, q_begin=0, q_end=0, t_begin=0, t_end=0,
            score=0, overflow=0, need=0, inexact=0)),
        codes=P(None, "data"), goal_i=P("data"), goal_j=P("data"),
        q_len=P("data"), t_len=P("data"), certified=P("data"))
    ispec = index_specs if index_specs is not None else P()
    fn = shard_map(
        local_step, mesh=mesh,
        in_specs=(P("data", None), P("data"), ispec, P(), P(), P()),
        out_specs=out_specs,
        check_vma=False)
    return jax.jit(fn)


def distributed_initialize_if_needed() -> None:
    """Multi-host init (jax.distributed).  No-op in single-process runs;
    controlled by the standard JAX coordinator env vars."""
    # NOTE: must run before first backend use (jax.devices() etc.).
    import os
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr and not getattr(distributed_initialize_if_needed, "_done", False):
        nproc = os.environ.get("JAX_NUM_PROCESSES")
        pid = os.environ.get("JAX_PROCESS_ID")
        jax.distributed.initialize(
            addr,
            num_processes=int(nproc) if nproc else None,
            process_id=int(pid) if pid else None)
        distributed_initialize_if_needed._done = True


def process_read_slice(n_records: int) -> tuple:
    """[lo, hi) contiguous slice of the global record list owned by this
    process - the per-host read sharding (SURVEY.md 2.2: reads sharded by
    host via per-host data loading).  Contiguous blocks keep the merged
    output in global input order."""
    p, n = jax.process_index(), jax.process_count()
    per = -(-n_records // n)          # ceil
    lo = min(p * per, n_records)
    return lo, min(lo + per, n_records)


def _merge_endpoint():
    """(host, port) of the process-0 merge socket, derived from the JAX
    coordinator address (which lives on process 0 by convention), or
    BIOINFO1_MERGE_HOST.  host is None when it cannot be derived (e.g. a
    cluster auto-initialized without a coordinator address): senders would otherwise
    connect to 127.0.0.1 - themselves - and hang out the full merge timeout
    (ADVICE r03); the caller falls back to the allgather merge instead."""
    import os
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS", "")
    host, _, port = addr.partition(":")
    host = os.environ.get("BIOINFO1_MERGE_HOST", host) or None
    mport = os.environ.get("BIOINFO1_MERGE_PORT")
    if mport:
        return host, int(mport)
    return host, (int(port) if port else 9400) + 17


def _p2p_gather_blobs(blob: bytes, timeout_s: float = 0.0):
    """Point-to-point gather of one byte blob per process TO process 0.

    Pod-shaped (VERDICT r02 item 4): the r02 implementation allgathered the
    full max-padded blob to EVERY process - O(P * max_blob) DCN traffic and
    memory per host.  Here each non-zero process opens one TCP connection
    to process 0 and streams its blob; total traffic is sum(blob sizes),
    received only where the output is written.  Returns [blob_p0, ...,
    blob_{P-1}] on process 0, None elsewhere.
    """
    import os
    import socket
    import struct
    p, n = jax.process_index(), jax.process_count()
    host, port = _merge_endpoint()
    if not timeout_s:
        # Processes reach the merge whenever their own map stage ends;
        # shard-skew between hosts is workload-dependent (retry ladders,
        # host fallbacks), so the window must scale way past any expected
        # skew rather than a fixed few minutes.
        timeout_s = float(os.environ.get("BIOINFO1_MERGE_TIMEOUT", 21600))
    if p == 0:
        blobs = {0: blob}
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("0.0.0.0", port))
        srv.listen(n)
        srv.settimeout(timeout_s)
        try:
            for _ in range(n - 1):
                conn, _a = srv.accept()
                conn.settimeout(timeout_s)
                with conn:
                    hdr = _recv_exact(conn, 12)
                    pid, size = struct.unpack("<iq", hdr)
                    blobs[pid] = _recv_exact(conn, size)
        finally:
            srv.close()
        return [blobs[i] for i in range(n)]
    # Sender: connect with retry (process 0 may not be listening yet).
    import time as _time
    deadline = _time.time() + timeout_s
    last_err = None
    while _time.time() < deadline:
        try:
            with socket.create_connection((host, port), timeout=10) as s:
                s.settimeout(timeout_s)
                s.sendall(struct.pack("<iq", p, len(blob)))
                s.sendall(blob)
            return None
        except OSError as e:
            last_err = e
            _time.sleep(0.2)
    raise RuntimeError(f"merge send to process 0 failed: {last_err}")


def _recv_exact(conn, size: int) -> bytes:
    chunks = []
    got = 0
    while got < size:
        b = conn.recv(min(1 << 22, size - got))
        if not b:
            raise RuntimeError("merge connection closed early")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


class MergeSession:
    """Liveness-aware merge channel (VERDICT r03 item 7).

    The plain p2p merge only detects a dead peer after the full merge
    timeout (hours): process 0 sits in accept() while the failed process
    never connects.  A MergeSession is created on every process BEFORE the
    map stage: non-zero processes open one TCP connection to process 0
    immediately and heartbeat every BIOINFO1_HB_INTERVAL (default 5 s)
    from a daemon thread; the PAF blob rides the same connection at merge
    time (framed, acked).  Process 0 watches the connections while it maps:
    a connection that closes early, goes silent past BIOINFO1_HB_GRACE
    (default 30 s), or never registers fails the run in SECONDS with a
    message naming the dead process and the resumable part files.

    Single-process runs are a no-op; when no merge host is derivable the
    session degrades to the allgather merge (no liveness - collective ops
    already fail fast on peer loss).
    """

    HELLO, HEARTBEAT, DATA, ACK = b"R", b"H", b"D", b"A"

    def __init__(self, part_hint: str = ""):
        import os
        import threading
        self.p = jax.process_index()
        self.n = jax.process_count()
        self.part_hint = part_hint
        self.mode = "p2p"
        if self.n == 1:
            self.mode = "single"
            return
        if (os.environ.get("BIOINFO1_MERGE") == "allgather"
                or _merge_endpoint()[0] is None):
            self.mode = "allgather"
            return
        self.hb_interval = float(os.environ.get("BIOINFO1_HB_INTERVAL", 5))
        self.hb_grace = float(os.environ.get("BIOINFO1_HB_GRACE", 30))
        self.timeout = float(os.environ.get("BIOINFO1_MERGE_TIMEOUT", 21600))
        import time as _t
        self.start_time = _t.time()
        self._lock = threading.Lock()
        self.blobs: dict = {}
        self.dead: dict = {}
        self.registered: set = set()
        self._send_done = threading.Event()
        self._send_err: list = []
        self._blob_ready = threading.Event()
        self._blob = b""
        self._debug(f"session created p={self.p}/{self.n}")
        if self.p == 0:
            import socket
            host, port = _merge_endpoint()
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("0.0.0.0", port))
            srv.listen(self.n)
            srv.settimeout(1.0)
            self._srv = srv
            self._closing = False
            t = threading.Thread(target=self._accept_loop, daemon=True)
            t.start()
        else:
            t = threading.Thread(target=self._sender_loop, daemon=True)
            t.start()

    # ---- process 0 ----
    def _accept_loop(self):
        import threading
        while not self._closing:
            try:
                conn, _a = self._srv.accept()
            except OSError:
                continue
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn):
        import struct
        import time as _t
        pid = -1
        try:
            conn.settimeout(self.hb_grace)
            hdr = _recv_exact(conn, 5)
            if hdr[:1] != self.HELLO:
                raise RuntimeError("bad hello frame")
            pid = struct.unpack("<i", hdr[1:])[0]
            with self._lock:
                self.registered.add(pid)
            while True:
                t = _recv_exact(conn, 1)
                if t == self.HEARTBEAT:
                    continue                      # settimeout re-arms
                if t == self.DATA:
                    size = struct.unpack("<q", _recv_exact(conn, 8))[0]
                    blob = _recv_exact(conn, size)
                    with self._lock:
                        self.blobs[pid] = blob
                    conn.sendall(self.ACK)
                    return
                raise RuntimeError(f"bad frame type {t!r}")
        except Exception as e:
            with self._lock:
                if pid not in self.blobs:
                    self.dead[pid] = repr(e)
            self._debug(f"reader for process {pid} ended: {e!r}")
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _debug(msg):
        import os
        import sys
        import time as _t
        if os.environ.get("BIOINFO1_DEBUG_MERGE"):
            print(f"bioinfo1-merge[{_t.time():.1f}]: {msg}",
                  file=sys.stderr, flush=True)

    # ---- non-zero processes ----
    def _sender_loop(self):
        import socket
        import struct
        import time as _t
        host, port = _merge_endpoint()
        deadline = _t.time() + max(self.hb_grace * 4, 120)
        sock = None
        try:
            last = None
            while _t.time() < deadline and sock is None:
                try:
                    sock = socket.create_connection((host, port), timeout=10)
                except OSError as e:
                    last = e
                    _t.sleep(0.2)
            if sock is None:
                raise RuntimeError(f"cannot reach merge host: {last}")
            sock.settimeout(self.timeout)
            sock.sendall(self.HELLO + struct.pack("<i", self.p))
            while not self._blob_ready.wait(self.hb_interval):
                sock.sendall(self.HEARTBEAT)
            blob = self._blob
            sock.sendall(self.DATA + struct.pack("<q", len(blob)))
            sock.sendall(blob)
            if _recv_exact(sock, 1) != self.ACK:
                raise RuntimeError("merge ack missing")
        except Exception as e:
            self._send_err.append(
                f"merge to process 0 failed (process 0 dead or "
                f"unreachable): {e}")
        finally:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            self._send_done.set()

    def _fail_msg(self, pid, why):
        hint = (f"; completed work is checkpointed in "
                f"{self.part_hint}.part<p>/.progress.p<p> - rerun all "
                f"processes with --resume" if self.part_hint else
                "; rerun to retry")
        return (f"bioinfo1: peer process {pid} failed during the run "
                f"({why}){hint}")

    def check(self):
        """Raise RuntimeError now if a peer is already known dead.

        Call from the map loop so a run aborts (resumably) within seconds
        of a peer failure instead of only at merge time."""
        if self.mode != "p2p":
            return
        if self.p == 0:
            with self._lock:
                for pid, why in self.dead.items():
                    raise RuntimeError(self._fail_msg(pid, why))
        elif self._send_err:
            raise RuntimeError(self._send_err[0])

    def gather(self, lines):
        """Merge this process's lines; list on process 0, None elsewhere.

        Raises RuntimeError promptly when a peer (or process 0) is dead.
        """
        import time as _t
        if self.mode == "single":
            return list(lines)
        if self.mode == "allgather":
            import sys
            print("bioinfo1: no merge host derivable "
                  "(set BIOINFO1_MERGE_HOST or JAX_COORDINATOR_ADDRESS); "
                  "using allgather merge (no liveness)", file=sys.stderr)
            return _gather_lines_allgather(lines)
        self._debug("gather entered")
        blob = ("\n".join(lines)).encode("utf-8")
        if self.p != 0:
            self._blob = blob
            self._blob_ready.set()
            if not self._send_done.wait(self.timeout):
                raise RuntimeError("merge send timed out")
            if self._send_err:
                raise RuntimeError(self._send_err[0])
            return None
        self.blobs[0] = blob
        deadline = _t.time() + self.timeout
        reg_deadline = self.start_time + max(self.hb_grace * 4, 120)
        while True:
            with self._lock:
                if len(self.blobs) == self.n:
                    break
                for pid, why in self.dead.items():
                    raise RuntimeError(self._fail_msg(pid, why))
                if _t.time() > reg_deadline:
                    missing = [p for p in range(1, self.n)
                               if p not in self.registered]
                    if missing:
                        raise RuntimeError(self._fail_msg(
                            missing[0], "never connected to the merge "
                            "liveness channel"))
            if _t.time() > deadline:
                raise RuntimeError("merge timed out")
            _t.sleep(0.05)
        self.close()
        merged = []
        for i in range(self.n):
            text = self.blobs[i].decode("utf-8")
            if text:
                merged.extend(text.split("\n"))
        return merged

    def close(self):
        if getattr(self, "_srv", None) is not None:
            self._closing = True
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None


def gather_lines_to_process0(lines):
    """Deterministic multi-host merge of output lines to process 0.

    The device-side replacement for the reference's nondeterministic
    ``omp critical`` stdout interleaving (team_mapper.cpp:685): each
    process's PAF lines (its contiguous read slice, already in input order)
    are streamed point-to-point to process 0 and concatenated in process
    order - so the merged stream is the exact single-process output.

    Returns the merged line list on process 0, None elsewhere.
    Single-process runs short-circuit (no collective).  Set
    BIOINFO1_MERGE=allgather to fall back to the collective path (e.g. when
    the merge port is firewalled).
    """
    if jax.process_count() == 1:
        return list(lines)
    import os
    if os.environ.get("BIOINFO1_MERGE") == "allgather":
        return _gather_lines_allgather(lines)
    if _merge_endpoint()[0] is None:
        # No coordinator host to connect to (pod auto-init): the p2p merge
        # cannot work; use the collective path rather than hanging.
        import sys
        print("bioinfo1: no merge host derivable "
              "(set BIOINFO1_MERGE_HOST or JAX_COORDINATOR_ADDRESS); "
              "using allgather merge", file=sys.stderr)
        return _gather_lines_allgather(lines)
    blob = ("\n".join(lines)).encode("utf-8")
    blobs = _p2p_gather_blobs(blob)
    if blobs is None:
        return None
    merged = []
    for b in blobs:
        text = b.decode("utf-8")
        if text:
            merged.extend(text.split("\n"))
    return merged


def _gather_lines_allgather(lines):
    """Collective fallback merge (the r02 shape: max-padded allgather)."""
    import numpy as np
    from jax.experimental import multihost_utils as mhu

    blob = ("\n".join(lines)).encode("utf-8")
    n = np.int64(len(blob))
    sizes = np.asarray(mhu.process_allgather(n))          # (P,)
    cap = int(sizes.max()) if sizes.size else 0
    padded = np.zeros((max(cap, 1),), dtype=np.uint8)
    padded[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    blobs = np.asarray(mhu.process_allgather(padded))     # (P, cap)
    if jax.process_index() != 0:
        return None
    merged = []
    for p in range(blobs.shape[0]):
        text = blobs[p, : int(sizes[p])].tobytes().decode("utf-8")
        if text:
            merged.extend(text.split("\n"))
    return merged
