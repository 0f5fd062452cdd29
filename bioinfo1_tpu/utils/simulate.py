"""ONT-like synthetic read simulator (substitutions + indels).

The reference's whole validation story is MAP006 ONT 2D reads against
E. coli K-12 (/root/reference/README.md:42, .gitignore:4-6, report section
5).  That dataset is not shipped, but its error PROFILE is what stresses a
banded aligner: ONT 2D reads carry ~10-15% total error split between
mismatches, insertions and deletions, and the indels drift the optimal
alignment path off the main diagonal - exactly what the banded wavefront's
exactness certificate (ops/band.certify) is sensitive to.  Substitution-
only synthetic reads (rounds 1-2) never exercise that.

Profile defaults approximate published MAP006 2D error rates: ~5%
mismatches, ~3% insertions, ~4% deletions, indel lengths geometric with
mean ~1.5 (homopolymer-biased deletions are not modeled; the band stress
comes from the NET offset drift, which the geometric model reproduces).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

BASES = np.frombuffer(b"CATG", dtype=np.uint8)


def mutate_read(frag: np.ndarray, rng: np.random.Generator,
                sub_rate: float = 0.05, ins_rate: float = 0.03,
                del_rate: float = 0.04,
                indel_geom_p: float = 0.6) -> np.ndarray:
    """Apply an ONT-like error profile to a uint8 base fragment.

    Per input base: substitute with ``sub_rate`` (uniform random base, so a
    quarter are silent - like the reference parity generators), start an
    insertion with ``ins_rate`` / a deletion with ``del_rate``, each of
    geometric length (mean 1/p).  Returns a new uint8 array.
    """
    n = len(frag)
    r = rng.random(n)
    out: List[np.ndarray] = []
    i = 0
    # Event positions are sparse; iterate events, bulk-copy between them.
    events = np.flatnonzero(r < sub_rate + ins_rate + del_rate)
    for e in events:
        if e < i:
            continue                       # swallowed by a deletion
        out.append(frag[i:e])
        x = r[e]
        if x < sub_rate:
            out.append(BASES[rng.integers(0, 4, 1)])
            i = e + 1
        elif x < sub_rate + ins_rate:
            ln = rng.geometric(indel_geom_p)
            out.append(frag[e:e + 1])
            out.append(BASES[rng.integers(0, 4, ln)])
            i = e + 1
        else:
            ln = int(rng.geometric(indel_geom_p))
            i = e + ln                     # drop ln bases
    out.append(frag[i:])
    return np.concatenate(out) if out else frag[:0]


def simulate_reads(genome: np.ndarray, lengths, rng: np.random.Generator,
                   sub_rate: float = 0.05, ins_rate: float = 0.03,
                   del_rate: float = 0.04, rc_prob: float = 0.5,
                   ) -> List[Tuple[str, str]]:
    """(name, seq) records sampled from ``genome`` (uint8 bytes) with the
    ONT error profile; about half reverse-complemented."""
    comp = np.arange(256, dtype=np.uint8)
    for a, b in zip(b"ATGC", b"TACG"):
        comp[a] = b
    recs = []
    for i, ln in enumerate(lengths):
        start = int(rng.integers(0, max(1, len(genome) - ln)))
        frag = mutate_read(genome[start:start + ln], rng,
                           sub_rate, ins_rate, del_rate)
        if rng.random() < rc_prob:
            frag = comp[frag[::-1]]
        recs.append((f"ont{i}", frag.tobytes().decode("latin1")))
    return recs


def region_pairs(rng: np.random.Generator, B: int, n: int, m: int,
                 min_frac: float = 0.5):
    """Packed alignment regions shaped like the mapper's: (q (B, n) uint8,
    q_lens (B,), t (B, m) uint8, t_lens (B,)).  Each query is an ONT-indel
    mutation of its target window, so the optimal paths stay near the main
    diagonal as chained regions do; lengths vary per row so padding lanes
    are exercised too."""
    q = np.zeros((B, n), np.uint8)
    t = np.zeros((B, m), np.uint8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        ln = int(rng.integers(max(1, int(n * min_frac)), n + 1))
        win = random_genome(min(m, ln + ln // 8 + 1), rng)
        read = mutate_read(win[:ln], rng)[:n]
        q[b, :len(read)] = read
        ql[b] = len(read)
        t[b, :len(win)] = win
        tl[b] = len(win)
    return q, ql, t, tl


def random_genome(n: int, rng: np.random.Generator) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def repeat_genome(n: int, rng: np.random.Generator,
                  is_elements: int = 40, is_len: int = 1300,
                  rrn_operons: int = 7, rrn_len: int = 5000,
                  tandem_loci: int = 60, tandem_unit: int = 120,
                  tandem_copies: int = 12,
                  divergence: float = 0.01,
                  rrn_divergence: float = 0.002) -> np.ndarray:
    """E. coli-like repeat-structured genome (VERDICT r03 item 3).

    A uniform-random genome never fires the mapper's repeat machinery (the
    frequency ban, match-budget overflow ladder, repeat-dense LIS); real
    genomes do.  This generator plants the K-12 repeat census into a random
    backbone:

      * ``is_elements`` copies of a shared insertion-sequence-like unit
        (IS1/IS2/IS5 analogs: ~40 copies of ~0.8-1.5 kb in K-12),
      * ``rrn_operons`` near-identical rRNA-operon-like regions (~5 kb -
        K-12 has 7), and
      * ``tandem_loci`` short tandem-repeat loci (unit repeated many times
        back to back - REP/BIME-like).

    Each planted copy is independently mutated at ``divergence`` so copies
    are near- but not perfectly identical (like real paralogs).  Placement
    is uniform without overlap handling (overwrites are fine - real
    elements nest too).  Returns uint8 bytes of length n.
    """
    g = BASES[rng.integers(0, 4, n)]

    def mutate(unit, div=None):
        u = unit.copy()
        d = divergence if div is None else div
        pos = rng.integers(0, len(u), max(1, int(len(u) * d)))
        u[pos] = BASES[rng.integers(0, 4, len(pos))]
        return u

    def plant(unit, copies, div=None):
        for _ in range(copies):
            u = mutate(unit, div)
            if rng.random() < 0.5:                       # either strand
                comp = np.arange(256, dtype=np.uint8)
                for a, b in zip(b"ATGC", b"TACG"):
                    comp[a] = b
                u = comp[u[::-1]]
            start = int(rng.integers(0, max(1, n - len(u))))
            g[start:start + len(u)] = u[: n - start]

    for _ in range(3):                                   # IS1/IS2/IS5-like
        plant(BASES[rng.integers(0, 4, is_len)], max(1, is_elements // 3))
    # rRNA operons are >99.9% identical in real K-12 - their minimizers
    # survive across copies and are the classic budget-overflow driver.
    plant(BASES[rng.integers(0, 4, rrn_len)], rrn_operons,
          div=rrn_divergence)
    for _ in range(tandem_loci):
        unit = BASES[rng.integers(0, 4, tandem_unit)]
        arr = np.concatenate([mutate(unit) for _ in range(tandem_copies)])
        start = int(rng.integers(0, max(1, n - len(arr))))
        g[start:start + len(arr)] = arr[: n - start]
    return g
