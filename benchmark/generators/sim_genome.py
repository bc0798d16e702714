"""Genomes with planted segmental duplications, written as soft-masked FASTA.

``simulate_genome`` is a copy of ``sedef_tpu_torch/models/genome_sim.py``
at commit a1f3aa7 (SEDEF's simulation mutation model, simulations.py:53-137):
the same draws in the same order, so the same genomes byte for byte.
``mosaic`` is a copy of ``chip_smoke.py``'s ``mosaic_genome`` core
re-randomisation.  The dense recipe's constants are those of
``sedef_tpu_torch/tools/rehearsal.py`` (150 families x 90 copies per 50 Mbp,
one SD per 120 Kbp, an N-run every 997 Kbp): the traffic file holds them.
"""

from __future__ import annotations

import bisect
import os
from dataclasses import dataclass

import numpy as np

_LOW = np.frombuffer(b"acgt", dtype=np.uint8)
_UP = np.frombuffer(b"ACGT", dtype=np.uint8)
_RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


@dataclass
class PlantedSD:
    chrom_a: str
    a_start: int
    a_end: int
    chrom_b: str
    b_start: int
    b_end: int
    is_rc: bool
    divergence: float


def revcomp(s: str) -> str:
    return s.encode().translate(_RC)[::-1].decode()


def _rand_codes(rng, n):
    return rng.integers(0, 4, n, dtype=np.int8)


def _mutate_codes(rng, codes: np.ndarray, rate: float,
                  deleted: list | None = None) -> np.ndarray:
    """SNPs (2/3 of errors) + 1 bp indels (1/3).  ``deleted``, if given,
    gets the sorted offsets the copy lost (the inserted bases go at its
    end)."""
    n = len(codes)
    snp = rng.random(n) < rate * 2 / 3
    out = codes.copy()
    out[snp] = (out[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
    indel = np.nonzero(rng.random(n) < rate / 3)[0]
    if len(indel):
        keep = np.ones(n, dtype=bool)
        dels = indel[rng.random(len(indel)) < 0.5]
        keep[dels] = False
        if deleted is not None:
            deleted.append(dels)
        pieces = [out[keep]]
        ins = indel[rng.random(len(indel)) < 0.5]
        if len(ins):
            pieces.append(_rand_codes(rng, len(ins)))
        out = np.concatenate(pieces)
    if deleted is not None and not len(indel):
        deleted.append(indel)
    return out


def _to_str(codes: np.ndarray, upper: bool) -> np.ndarray:
    return (_UP if upper else _LOW)[codes]


def simulate_genome(length: int = 5_000_000, n_sds: int = 20,
                    sd_min: int = 1500, sd_max: int = 40_000,
                    max_divergence: float = 0.12, rc_fraction: float = 0.3,
                    n_chroms: int = 1, seed=0,
                    n_run_every: int = 0,
                    repeat_families: int = 0, repeat_copies: int = 0,
                    repeat_len: tuple[int, int] = (400, 2500),
                    repeat_div: tuple[float, float] = (0.08, 0.40),
                    sd_specs: list[tuple[int, float, bool]] | None = None,
                    deleted: list | None = None
                    ) -> tuple[dict[str, str], list[PlantedSD]]:
    """Returns ({chrom_name: sequence}, planted SD list): lowercase random
    background, uppercase SD copies and repeat-family copies at random
    non-overlapping places (see the port's ``genome_sim``).  ``sd_specs``
    gives each SD's (length, divergence, reverse) in place of its three
    draws; without it the draws are the original's.  ``deleted``, if given,
    gets each planted SD's offsets its second copy lost."""
    rng = np.random.default_rng(seed)
    per_chrom = length // n_chroms
    buf = {}
    for ci in range(n_chroms):
        buf[f"chrS{ci + 1}"] = _to_str(_rand_codes(rng, per_chrom),
                                       upper=False).copy()
    names = list(buf)

    planted: list[PlantedSD] = []
    occ_starts: dict[str, list[int]] = {n: [] for n in names}
    occ_ends: dict[str, list[int]] = {n: [] for n in names}

    def place(name, ln):
        st, en = occ_starts[name], occ_ends[name]
        for _ in range(200):
            s = int(rng.integers(0, per_chrom - ln - 1))
            i = bisect.bisect_right(st, s)
            if (i == 0 or en[i - 1] <= s) and \
                    (i == len(st) or s + ln <= st[i]):
                st.insert(i, s)
                en.insert(i, s + ln)
                return s
        return None

    for si in range(n_sds):
        if sd_specs is None:
            ln = int(rng.integers(sd_min, sd_max))
            div = float(rng.uniform(0.0, max_divergence))
            is_rc = bool(rng.random() < rc_fraction)
        else:
            ln, div, is_rc = sd_specs[si]
        ca = names[int(rng.integers(0, len(names)))]
        cb = names[int(rng.integers(0, len(names)))]
        codes = _rand_codes(rng, ln)
        lost = []
        copy_codes = _mutate_codes(rng, codes, div, lost)
        sa = place(ca, ln)
        sb = place(cb, len(copy_codes))
        if sa is None or sb is None:
            continue
        if deleted is not None:
            deleted.append(lost[0])
        buf[ca][sa:sa + ln] = _to_str(codes, upper=True)
        b_str = _to_str(copy_codes, upper=True)
        if is_rc:
            b_str = np.frombuffer(revcomp(b_str.tobytes().decode()).encode(),
                                  dtype=np.uint8)
        buf[cb][sb:sb + len(b_str)] = b_str
        planted.append(PlantedSD(ca, sa, sa + ln, cb, sb,
                                 sb + len(copy_codes), is_rc, div))

    for fam in range(repeat_families):
        ln = int(rng.integers(repeat_len[0], repeat_len[1]))
        ancestor = _rand_codes(rng, ln)
        for ci in range(repeat_copies):
            div = float(rng.uniform(repeat_div[0], repeat_div[1]))
            copy = _mutate_codes(rng, ancestor, div)
            cc = names[int(rng.integers(0, len(names)))]
            sc = place(cc, len(copy))
            if sc is None:
                continue
            cstr = _to_str(copy, upper=True)
            if rng.random() < rc_fraction:
                cstr = np.frombuffer(revcomp(cstr.tobytes().decode()).encode(),
                                     dtype=np.uint8)
            buf[cc][sc:sc + len(cstr)] = cstr

    if n_run_every:
        for name in names:
            st, en = occ_starts[name], occ_ends[name]
            for pos in range(n_run_every, per_chrom - 200, n_run_every):
                i = bisect.bisect_right(st, pos)
                if (i == 0 or en[i - 1] <= pos) and \
                        (i == len(st) or pos + 150 <= st[i]):
                    buf[name][pos:pos + 150] = ord("N")
    return {n: buf[n].tobytes().decode() for n in names}, planted


def mosaic(chroms: dict[str, str], planted: list[PlantedSD], rng,
           cores: tuple, keeps: tuple, deleted: list
           ) -> tuple[dict[str, str], list[PlantedSD]]:
    """Re-randomise cores of every forward SD in both copies (diverged
    duplicon blocks between conserved ones): SD i takes cores[i % 2] and
    keeps[i % 2], each a (low, high) length range of its first copy, and
    the second copy's core lies at the homologous place (the offsets shifted
    by the bases the copy lost before them, ``deleted[i]``).  Returns the
    genome and the conserved blocks, each a pair of homologous intervals
    (the last one to the end of the first copy and of its homologue)."""
    bufs = {n: bytearray(s, "ascii") for n, s in chroms.items()}
    blocks = []
    for si, sd in enumerate(planted):
        if sd.is_rc:
            continue

        def on_b(x, lost=deleted[si]):
            return x - int(np.searchsorted(lost, x))
        core, keep = cores[si % 2], keeps[si % 2]
        span = sd.a_end - sd.a_start
        kept = 0
        pos = int(rng.integers(*keep))
        while True:
            ln = int(rng.integers(*core))
            if pos + ln + keep[1] > span:
                break
            blocks.append(PlantedSD(sd.chrom_a, sd.a_start + kept,
                                    sd.a_start + pos, sd.chrom_b,
                                    sd.b_start + on_b(kept),
                                    sd.b_start + on_b(pos),
                                    False, sd.divergence))
            for name, st, lo, hi in (
                    (sd.chrom_a, sd.a_start, pos, pos + ln),
                    (sd.chrom_b, sd.b_start, on_b(pos), on_b(pos + ln))):
                bufs[name][st + lo:st + hi] = \
                    _UP[rng.integers(0, 4, hi - lo)].tobytes()
            kept = pos + ln
            pos += ln + int(rng.integers(*keep))
        blocks.append(PlantedSD(sd.chrom_a, sd.a_start + kept, sd.a_end,
                                sd.chrom_b, sd.b_start + on_b(kept),
                                sd.b_start + on_b(span), False,
                                sd.divergence))
    return {n: b.decode() for n, b in bufs.items()}, blocks


def write_fasta(path: str, chroms: dict[str, str], width: int = 80) -> None:
    """The FASTA and its samtools index (``.fai``) beside it."""
    fai = []
    off = 0
    with open(path, "w") as f:
        for name, seq in chroms.items():
            off += len(name) + 2
            fai.append(f"{name}\t{len(seq)}\t{off}\t{width}\t{width + 1}\n")
            f.write(f">{name}\n")
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + "\n")
            off += len(seq) + -(-len(seq) // width)
    with open(path + ".fai", "w") as f:
        f.writelines(fai)


def entropy(seed: int, *sub: int) -> np.random.SeedSequence:
    """The seed sequence of (seed, sub...) for any whole seed."""
    return np.random.SeedSequence([seed % (1 << 64), *sub])


def sd_specs(recipe: dict, sizes_seed: int, stream: int, k: int
             ) -> list[tuple[int, float, bool]]:
    """Genome k's SD (length, divergence, reverse) triples, drawn as the
    recipe draws them but from (sizes_seed, stream, k): the same for every
    run's seed."""
    rng = np.random.default_rng(entropy(sizes_seed, stream, k))
    return [(int(rng.integers(recipe["sd_min"], recipe["sd_max"])),
             float(rng.uniform(0.0, recipe["max_divergence"])),
             bool(rng.random() < recipe["rc_fraction"]))
            for _ in range(recipe["n_sds"])]


def make(params: dict, seed: int, workdir: str, stream: int, count: int
         ) -> list[dict]:
    """``count`` genomes of the recipe in ``params`` from (seed, stream,
    k): each written to ``workdir/g<stream>_<k>/genome.fa``.  With
    ``sizes_seed`` in ``params``, genome k's SD sizes, divergences and
    orientations come from it (``sd_specs``) and the seed draws the rest:
    every seed then asks for the same work.  Returns
    [{"fasta", "bases", "planted"}], "planted" the pairs of homologous
    intervals: the planted SDs, and with ``mosaic`` the reverse SDs and the
    mosaics' conserved blocks."""
    recipe = dict(params["recipe"])
    for key in ("repeat_len", "repeat_div"):
        if key in recipe:
            recipe[key] = tuple(recipe[key])
    out = []
    for k in range(count):
        rng_seed = entropy(seed, stream, k)
        specs = (sd_specs(recipe, params["sizes_seed"], stream, k)
                 if "sizes_seed" in params else None)
        deleted = []
        chroms, planted = simulate_genome(seed=rng_seed, sd_specs=specs,
                                          deleted=deleted, **recipe)
        if "mosaic" in params:
            m = params["mosaic"]
            chroms, blocks = mosaic(
                chroms, planted,
                np.random.default_rng(entropy(seed, stream, k, 1)),
                tuple(map(tuple, m["cores"])), tuple(map(tuple, m["keeps"])),
                deleted)
            planted = [sd for sd in planted if sd.is_rc] + blocks
        d = os.path.join(workdir, f"g{stream}_{k}")
        os.makedirs(d, exist_ok=True)
        fa = os.path.join(d, "genome.fa")
        write_fasta(fa, chroms)
        out.append({"fasta": fa, "bases": sum(map(len, chroms.values())),
                    "planted": planted})
    return out
