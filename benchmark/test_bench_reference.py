"""The plain reference itself: its DP against a brute-force recurrence and
against the program's gap DPs, its row checks on rows built by hand, and
its coverage arithmetic."""

import numpy as np
import pytest

from reference import cover, dp, rows

SC = {"match": 5, "mismatch": -4, "gap_open": 40, "gap_ext": 1}


def brute(q, t, sc):
    """Gotoh's three matrices, cell by cell."""
    o, e = sc["gap_open"], sc["gap_ext"]
    n, m, neg = len(q), len(t), -10**9
    H = [[neg] * (m + 1) for _ in range(n + 1)]
    E = [[neg] * (m + 1) for _ in range(n + 1)]
    F = [[neg] * (m + 1) for _ in range(n + 1)]
    H[0][0] = 0
    for i in range(n + 1):
        for j in range(m + 1):
            if i == j == 0:
                continue
            if j:
                E[i][j] = max(H[i][j - 1] - o - e, E[i][j - 1] - e)
            if i:
                F[i][j] = max(H[i - 1][j] - o - e, F[i - 1][j] - e)
            best = max(E[i][j], F[i][j])
            if i and j:
                a, b = q[i - 1], t[j - 1]
                s = 0 if 4 in (a, b) else (sc["match"] if a == b
                                           else sc["mismatch"])
                best = max(best, H[i - 1][j - 1] + s)
            H[i][j] = best
    return H[n][m]


@pytest.mark.parametrize("seed", range(4))
def test_best_score_is_the_recurrence(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        n, m = rng.integers(0, 18, 2)
        q = rng.integers(0, 5, n).astype(np.int8)
        t = rng.integers(0, 5, m).astype(np.int8)
        if rng.random() < 0.5:
            t = q.copy()
            t[rng.random(len(t)) < 0.2] = 1
        assert dp.best_score(q, t, SC) == brute(list(q), list(t), SC)


def test_path_score_and_deficit():
    q, t = dp.codes("ACGTACGT"), dp.codes("ACGAACGT")
    assert dp.path_score(q, t, [("M", 8)], SC) == 7 * 5 - 4
    assert dp.deficit(q, t, [("M", 8)], SC) == 0
    # a detour through two gaps scores lower; a wrong span is no path
    assert dp.deficit(q, t, [("M", 3), ("D", 1), ("I", 1), ("M", 4)],
                      SC) == 2 * 41 - 4  # two gaps for one mismatch
    assert dp.path_score(q, t, [("M", 7)], SC) is None
    assert dp.deficit(q, t, [("M", 4), ("X", 4)], SC) is None
    assert dp.codes("acgN").tolist() == [0, 1, 2, 4]


def test_program_gap_dps_are_optimal():
    """The program's aligner on the CPU (the subject, not the reference)
    answers at the optimum; its answers cut short do not."""
    from sedef_tpu_torch.config import DEFAULT
    from sedef_tpu_torch.ops.wavefront import WavefrontAligner
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(40):
        n = int(rng.integers(1, 300))
        q = rng.integers(0, 4, n).astype(np.int8)
        t = q.copy()
        t[rng.random(n) < 0.15] = rng.integers(0, 4)
        t = np.concatenate([t, rng.integers(0, 4, int(rng.integers(0, 80)))
                            .astype(np.int8)])
        jobs.append((q, t))
    out = WavefrontAligner(DEFAULT, device="cpu").align_batch(jobs)
    assert [dp.deficit(q, t, c, SC) for (q, t), c in zip(jobs, out)] == \
        [0] * len(jobs)
    q, t = jobs[0]
    assert dp.deficit(q, t, [("M", len(q)), ("I", len(t) - len(q))],
                      SC) >= 0


GENOME = {"c1": b"acgtACGTACGTTTGACCA" * 10, "c2": b"ttACGTACGATTTGACCAgg" * 10}


def _aligned(a0, a1, b0, b1, cigar, strand="+"):
    a = GENOME["c1"][a0:a1]
    b = GENOME["c2"][b0:b1]
    if strand == "-":
        b = rows.revcomp(b)
    g = rows.gapped(a, b, rows.parse_cigar(cigar))
    t = rows.error_tallies(*g, rows.parse_cigar(cigar))
    m, gp = rows.errors(t)
    return "\t".join(map(str, [
        "c1", a0, a1, "c2", b0, b1, "", f"{m + gp:.1f}", "+", strand,
        max(a1 - a0, b1 - b0), t["span"], cigar, f"m={m:.1f};g={gp:.1f}"]))


def test_aligned_row_checks():
    line = _aligned(4, 19, 2, 17, "9M1D2M1I3M")
    assert rows.aligned_row_faults(line, GENOME) == 0
    f = line.split("\t")
    for i, v in ((1, "5"), (12, "9M1D2M1I2M"), (7, "3.0"), (13, "m=0.0;g=0.0")):
        g = list(f)
        g[i] = v
        assert rows.aligned_row_faults("\t".join(g), GENOME) == 1
    assert rows.aligned_row_faults(_aligned(0, 12, 0, 12, "12M", "-"),
                                   GENOME) == 0


def test_final_row_checks():
    """A final row built from the definitions passes; one number off, or
    a filter it fails, is caught."""
    a = GENOME["c1"][0:190]
    b = GENOME["c2"][0:190]
    cig = [("M", 190)]
    c = rows.final_columns(*rows.gapped(a, b, cig), cig)
    m, gp = rows.errors(c)

    def fmt(x):
        return "-nan" if x != x else f"{x:g}"
    line = "\t".join(map(str, [
        "c1", 0, 190, "c2", 0, 190, "S", f"{m + gp:.1f}", "+", "+", 190,
        c["span"], f"m={m:.1f};g={gp:.1f}",
        *[c[k] for k in rows._FINAL_INTS],
        *[fmt(c[k]) for k in rows._FINAL_FLOATS],
        *[c[k] for k in rows._FINAL_TAIL], "190M",
        fmt(1 - c["error_scaled"])]))
    loose = {"min_read": 100, "min_uppercase": 10, "max_scaled_error": 1.0,
             "big_overlap": 100}
    assert rows.final_row_faults(line, GENOME, loose) == 0
    f = line.split("\t")
    f[16] = str(int(f[16]) + 1)
    assert rows.final_row_faults("\t".join(f), GENOME, loose) == 1
    assert rows.final_row_faults(line, GENOME,
                                 dict(loose, min_read=1000)) == 1


def test_planted_coverage():
    class SD:
        chrom_a, a_start, a_end = "c1", 100, 200
        chrom_b, b_start, b_end = "c2", 500, 600
    assert cover.union_length([(0, 10), (5, 20), (30, 31)]) == 21
    full = ["c1\t90\t210\tc2\t490\t610", "c2\t500\t600\tc1\t100\t150"]
    assert cover.planted_coverage(full, [SD]) == (200, 200)
    half = ["c1\t100\t150\tc2\t500\t550"]
    assert cover.planted_coverage(half, [SD]) == (100, 200)
    off = ["c1\t100\t150\tc2\t0\t50"]  # the other side elsewhere
    assert cover.planted_coverage(off, [SD]) == (0, 200)
