"""Banded alignment fill: one entry point over the GPU kernel and the lax twin.

``fill_banded`` fills a fixed band of W diagonals around the main diagonal
(all three modes, score-only or with 2-bit parents).  On a CUDA device it
runs the Hopper kernel in native/band_fill.cu through the XLA FFI: one
thread block per read owns the whole anti-diagonal loop.  Everywhere else
(the CPU test backend) it runs the lax twin,
ops/align.align_banded_parents, which is also the kernel's reference: both
produce the same scores, goal cells and parent words bit for bit.  The
choice is made by ``jax.lax.platform_dependent`` at lowering time, so one
traced step serves every backend.  On a GPU a kernel that cannot be built
or loaded is an error, never a silent switch to the twin.

Coordinates: anti-diagonal d = i + j, lane l holds offset o = j - i =
2l - W + (d & 1).  ``certify`` proves when the banded result equals the
full DP's (score, and with ``strict`` the traceback too).
"""

from __future__ import annotations

import functools
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from bioinfo1_tpu.ops import align as al

#: Band widths are rounded up to this many lanes: one warp's worth, so every
#: warp of the kernel holds whole 16-lane parent words.  It divides 128, so
#: the mapper's 128-rounded bands reach the kernel unchanged.
LANE_MULTIPLE = 32

_DASH = 45           # ord('-')
KERNEL_TARGET = "bioinfo1_band_fill"   # the FFI call's name in lowered HLO
_SMEM_LIMIT = 227 * 1024
_MAX_THREADS = 1024

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "band_fill.cu")
_LIB = os.path.join(_REPO, "build", "libbioinfo1_band.so")
_lock = threading.Lock()
_registered = False


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_width(band: int) -> int:
    """The band W a requested ``band`` runs at (rounded up to
    LANE_MULTIPLE); the traceback walk takes this W."""
    return _round_up(max(band, LANE_MULTIPLE), LANE_MULTIPLE)


def _build_library() -> str:
    """Compile native/band_fill.cu for sm_90a into build/ (atomic rename, so
    a concurrent or interrupted build never leaves a torn library)."""
    if (os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    nvcc = os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc")
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.tmp{os.getpid()}"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the band-fill kernel failed:\n{proc.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def ensure_kernel() -> None:
    """Build (if stale) and register the CUDA band-fill kernel.  Raises on
    any failure: a GPU run never falls back to the lax twin."""
    global _registered
    with _lock:
        if _registered:
            return
        import ctypes
        lib = ctypes.cdll.LoadLibrary(_build_library())
        jax.ffi.register_ffi_target(
            KERNEL_TARGET, jax.ffi.pycapsule(lib.Bioinfo1BandFill),
            platform="CUDA")
        _registered = True


def _has_cuda_device() -> bool:
    return any(d.platform == "gpu" for d in jax.devices())


def _launch_shape(W: int):
    """(threads per block, band rows in shared memory?) - the rule
    native/band_fill.cu's launch_shape applies."""
    threads = min(W, _MAX_THREADS)
    in_smem = 12 * W + 16 * threads <= _SMEM_LIMIT
    return threads, in_smem


def _kernel_shapes(B: int, n: int, m: int, W: int, want_parents: bool):
    """(result ShapeDtypeStructs, m_eff) of one kernel call.  Parents match
    the lax twin's (n + m_eff - 1, B, W/16) layout; unused outputs are
    one-element placeholders."""
    m_eff = min(m, n + W)
    steps = n + m_eff - 1
    _, in_smem = _launch_shape(W)
    i32 = jnp.int32
    shapes = (
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((B,), i32),
        jax.ShapeDtypeStruct((steps, B, W // 16) if want_parents
                             else (1, 1, 1), jnp.uint32),
        jax.ShapeDtypeStruct((1,) if in_smem else (B, 3 * W), i32),
    )
    return shapes, m_eff


def kernel_fill(q_bytes, q_lens, t_bytes, t_lens, scoring, *, W: int,
                mode: int, want_parents: bool,
                dash_free: bool) -> al.AlignOut:
    """The CUDA kernel call (GPU only).  ``W`` must be a multiple of
    LANE_MULTIPLE; ``scoring`` is the (3,) int32 (match, mismatch, gap)."""
    if _has_cuda_device():
        ensure_kernel()
    B, n = q_bytes.shape
    m = t_bytes.shape[1]
    shapes, m_eff = _kernel_shapes(B, n, m, W, want_parents)
    score, gi, gj, parents, _ = jax.ffi.ffi_call(KERNEL_TARGET, shapes)(
        q_bytes.astype(jnp.uint8), q_lens.astype(jnp.int32),
        t_bytes.astype(jnp.uint8), t_lens.astype(jnp.int32),
        scoring.astype(jnp.int32),
        W=np.int32(W), mode=np.int32(mode), want_parents=bool(want_parents),
        dash_free=bool(dash_free), m_eff=np.int32(m_eff))
    if not want_parents:
        parents = jnp.zeros((0, 0, 0), jnp.uint32)
    return al.AlignOut(score=score, goal_i=gi, goal_j=gj, parents=parents)


def twin_fill(q_bytes, q_lens, t_bytes, t_lens, scoring, *, W: int,
              mode: int, want_parents: bool) -> al.AlignOut:
    """The lax twin at the same band (the kernel's reference)."""
    return al.align_banded_parents(
        q_bytes, q_lens, t_bytes, t_lens, scoring[0], scoring[1],
        scoring[2], band=W, mode=mode, want_parents=want_parents)


@functools.partial(jax.jit, static_argnames=("band", "mode", "want_parents",
                                              "dash_free"))
def fill_banded(q_bytes: jax.Array, q_lens: jax.Array, t_bytes: jax.Array,
                t_lens: jax.Array, match: jax.Array, mismatch: jax.Array,
                gap: jax.Array, *, band: int, mode: int = al.MODE_GLOBAL,
                want_parents: bool = False,
                dash_free: bool = False) -> al.AlignOut:
    """Banded fill at W = band rounded up to LANE_MULTIPLE.

    Returns AlignOut: score/goal_i/goal_j (B,) int32 (exact iff
    ``certify``), parents (n + m_eff - 1, B, W/16) uint32 when
    ``want_parents`` else a (0, 0, 0) placeholder; m_eff = min(m, n + W).
    ``dash_free`` promises no input byte is '-' (the kernel then drops the
    free-gap tests); the twin ignores it, its results being the same.
    """
    W = band_width(band)
    scoring = jnp.stack([jnp.asarray(match, jnp.int32),
                         jnp.asarray(mismatch, jnp.int32),
                         jnp.asarray(gap, jnp.int32)])
    kw = dict(W=W, mode=mode, want_parents=want_parents)
    return jax.lax.platform_dependent(
        q_bytes, q_lens, t_bytes, t_lens, scoring,
        cuda=functools.partial(kernel_fill, dash_free=dash_free, **kw),
        default=functools.partial(twin_fill, **kw))


def certify(score: jax.Array, q_bytes: jax.Array, q_lens: jax.Array,
            t_bytes: jax.Array, t_lens: jax.Array,
            match: jax.Array, mismatch: jax.Array, gap: jax.Array,
            band: int, strict: bool = False, mode: int = 0) -> jax.Array:
    """(B,) bool: the banded score provably equals the full DP's.

    ``strict`` additionally guarantees the TRACEBACK is byte-identical: with
    score strictly beating the bound no out-of-band path can even tie, so
    the canonical M>I>D path of the full DP lies entirely in-band, every
    cell on it keeps its full-DP value (the in-band path prefix realizes
    it), and band-masked competitors (whose values only shrink) cannot flip
    any first-set strictly-greater parent choice.  Use it when consuming
    banded parents; the score-only path does not need it (a tying path
    yields the same score).

    Mode-specific bounds (gap <= 0 required; W = band rounded up to
    LANE_MULTIPLE, as fill_banded does):
      * global (0): an out-of-band path pays >= 2*(W-1) - |m-n| gaps, so it
        scores at most maxsub*min(n,m) + gap*(2*(W-1) - |m-n|); literal '-'
        bytes make gaps free (team_alignment.cpp:25-28) and void it.
      * local (1) / semiGlobal (2): paths may start/end anywhere, so the
        gap argument fails, but any path TOUCHING offset >= W-1 (or
        <= -(W-1)) fits at most min(n, m-W+1) (resp. min(m, n-W+1))
        diagonal steps, each worth at most maxsub; free '-' gaps add
        nothing under gap <= 0.  Bound = maxsub * that count.  The argmax /
        rim-scan tie order is also preserved: any cell tying the banded best
        must have an in-band optimal path (an out-of-band one is capped by
        the bound), hence its banded value is exact, and the fill replicates
        the reference's scan order among in-band cells.
    """
    W = band_width(band)
    ql = q_lens.astype(jnp.int32)
    tl = t_lens.astype(jnp.int32)
    diff = tl - ql
    # Band covers the whole matrix: every offset o in [-n, m] is in
    # [-W, W-2] -> banded IS the full DP (no score test needed).
    whole = (ql <= W) & (tl <= W - 2)
    maxsub = jnp.maximum(jnp.maximum(match, mismatch), 0).astype(jnp.int32)
    if mode == 0:
        goal_in_band = (diff >= -W) & (diff <= W - 2)
        gaps_min = 2 * (W - 1) - jnp.abs(diff)
        bound = (maxsub * jnp.minimum(ql, tl)
                 + jnp.asarray(gap, jnp.int32) * gaps_min)
        no_dash = ~(jnp.any(q_bytes == _DASH, axis=1)
                    | jnp.any(t_bytes == _DASH, axis=1))
        beats = (score > bound) if strict else (score >= bound)
        strong = (gap < 0) & no_dash & beats
        return goal_in_band & (whole | strong)
    bound = maxsub * jnp.clip(
        jnp.maximum(jnp.minimum(ql, tl - (W - 1)),
                    jnp.minimum(tl, ql - (W - 1))), 0, None)
    beats = (score > bound) if strict else (score >= bound)
    strong = (gap <= 0) & beats
    return whole | strong


def parity_mismatches(q_bytes, q_lens, t_bytes, t_lens, scoring, *,
                      band: int, mode: int, want_parents: bool,
                      dash_free=(False, True)) -> list:
    """(dash_free, field) pairs on which the CUDA kernel and the lax twin
    disagree; empty = bit-identical.  The twin runs once, the kernel once
    per ``dash_free`` value.  Needs a GPU.  All arithmetic is int32, so the
    comparison is exact equality."""
    W = band_width(band)
    kw = dict(W=W, mode=mode, want_parents=want_parents)
    args = tuple(jnp.asarray(a) for a in
                 (q_bytes, q_lens, t_bytes, t_lens, scoring))
    want = jax.device_get(jax.jit(functools.partial(twin_fill, **kw))(*args))
    bad = []
    for df in dash_free:
        got = jax.device_get(jax.jit(functools.partial(
            kernel_fill, dash_free=df, **kw))(*args))
        for field in ("score", "goal_i", "goal_j", "parents"):
            a = np.asarray(getattr(got, field))
            b = np.asarray(getattr(want, field))
            if a.shape != b.shape or not np.array_equal(a, b):
                bad.append((df, field))
        del got
    return bad
