"""How much of the planted homology the program's rows cover.

The generators know the truth: a simulated pair's two copies are homologous
end to end, and a genome's planted SDs are pairs of intervals.  A row
covers the bases of a planted copy that it spans while its other side
overlaps the other copy.  A run that leaves work out covers less.
"""

from __future__ import annotations


def union_length(intervals) -> int:
    """Bases covered by half-open intervals."""
    total = 0
    end = None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _overlap(s0, e0, s1, e1) -> tuple[int, int] | None:
    s, e = max(s0, s1), min(e0, e1)
    return (s, e) if s < e else None


def planted_coverage(rows: list[str], planted) -> tuple[int, int]:
    """(bases of the planted SDs' copies covered by rows that link them,
    all the copies' bases).  A row is BED-like: chrom, start, end of each
    side in columns 0-5; an SD's copies are (chrom_a, a_start, a_end) and
    (chrom_b, b_start, b_end)."""
    sides = []
    for line in rows:
        f = line.split("\t")
        sides.append(((f[0], int(f[1]), int(f[2])),
                      (f[3], int(f[4]), int(f[5]))))
    covered = total = 0
    for sd in planted:
        a = (sd.chrom_a, sd.a_start, sd.a_end)
        b = (sd.chrom_b, sd.b_start, sd.b_end)
        total += (a[2] - a[1]) + (b[2] - b[1])
        on_a, on_b = [], []
        for x, y in sides:
            for one, other in ((x, y), (y, x)):
                if one[0] != a[0] or other[0] != b[0]:
                    continue
                ia = _overlap(one[1], one[2], a[1], a[2])
                ib = _overlap(other[1], other[2], b[1], b[2])
                if ia and ib:
                    on_a.append(ia)
                    on_b.append(ib)
        covered += union_length(on_a) + union_length(on_b)
    return covered, total
