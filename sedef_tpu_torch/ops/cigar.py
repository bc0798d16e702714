"""Counterpart of ``sedef_tpu/ops/cigar.py``.

Alignment object and CIGAR algebra.

Semantics-equivalent rewrite of the reference ``Alignment`` class
(``src/align.h:32-103``, ``src/align.cc``): gapped-string construction,
error tallies, max-scoring-prefix/suffix trimming, CIGAR surgery, and
alignment merging.  The per-column loops of the reference are replaced by
vectorized NumPy scans (cumulative score + argmax) where observable
behaviour allows; tie-breaking matches the reference's ``>=`` update rules.

CIGAR ops ('M'/'D'/'I'): 'M' consumes both sequences, 'D' consumes only
``a`` (query), 'I' consumes only ``b`` (reference) — align.cc:283-296.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ..config import DEFAULT, Config
from .dna import encode_align
from .wavefront import GapBatch, WavefrontAligner, cigar_runs

_DASH = ord("-")
_N = ord("N")
_M, _D, _I = ord("M"), ord("D"), ord("I")
_CIGAR_RE = re.compile(r"(\d*)([A-Za-z])")


def _ceq_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Case-insensitive equality, never true for '-' or 'N' (align.cc:29-35)."""
    au = np.where((a >= 97) & (a <= 122), a - 32, a)
    bu = np.where((b >= 97) & (b <= 122), b - 32, b)
    ok = (a != _DASH) & (b != _DASH) & (au != _N) & (bu != _N)
    return ok & (au == bu)


_default_aligner: WavefrontAligner | None = None


def _gap_jobs(qstr: str, rstr: str, qpe: np.ndarray, rpe: np.ndarray,
              qgap: np.ndarray, rgap: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray, GapBatch]:
    """The reference's gap policy (align.cc:126-145) over arrays of gaps
    ``qstr[qpe:qpe + qgap]`` / ``rstr[rpe:rpe + rgap]``: a gap with both
    sides is a DP, of both sides whole where each is at most 1,000 bases,
    else ("big") of their first min(qgap, rgap) bases followed by one
    indel of the rest, ``I`` where qgap <= rgap (of length 0 where they
    are equal), else ``D`` (the reference's ma1/ma2 comparison is a no-op,
    ma1 always wins); a one-sided gap is one indel.  Returns (dp, big,
    jobs): the gaps that take a DP, those that are big, and the DP
    problems in gap order, a ``GapBatch`` over the two strings' codes."""
    dp = (qgap > 0) & (rgap > 0)
    if not dp.any():
        return dp, dp, GapBatch.of([])
    big = dp & ((qgap > 1000) | (rgap > 1000))
    mi = np.minimum(qgap, rgap)
    # NOTE: the chunked align_strings path only matters above
    # MAX_KSW_SEQ_LEN = 60 Kbp; double-sided DP jobs here are bounded by
    # MAX_GAP = 10 Kbp (refine) so plain align_batch is equivalent.
    # Each string is encoded once; a problem is an offset and a length.
    return dp, big, GapBatch(encode_align(qstr), encode_align(rstr),
                             qpe[dp], np.where(big, mi, qgap)[dp],
                             rpe[dp], np.where(big, mi, rgap)[dp])


def _batch_gap_cigars(qstr: str, rstr: str,
                      gaps: list[tuple[int, int, int, int]],
                      aligner: WavefrontAligner
                      ) -> list[list[tuple[str, int]]]:
    """CIGARs for inter-block gaps (qpe, qs, rpe, rs), batched through the
    aligner under :func:`_gap_jobs`' policy."""
    if not gaps:
        return []
    qpe, qs, rpe, rs = np.array(gaps, dtype=np.int64).T
    dp, big, jobs = _gap_jobs(qstr, rstr, qpe, rpe, qs - qpe, rs - rpe)
    cigars = iter(aligner.align_batch(jobs) if len(jobs) else [])
    out: list[list[tuple[str, int]]] = []
    for qgap, rgap, d, b in zip((qs - qpe).tolist(), (rs - rpe).tolist(),
                                dp.tolist(), big.tolist()):
        if d:
            cig = list(next(cigars))
            if b:
                cig.append(("I" if qgap <= rgap else "D", abs(qgap - rgap)))
        elif qgap:
            cig = [("D", qgap)]
        elif rgap:
            cig = [("I", rgap)]
        else:
            cig = []
        out.append(cig)
    return out


def default_aligner() -> WavefrontAligner:
    """The process-wide aligner on ``cuda``: a ``MeshAligner`` over every
    card where the host has more than one, else the one card's
    ``WavefrontAligner``.  It raises where there is no card: the CPU is
    used only when a caller asks for it by name
    (``WavefrontAligner(device="cpu")``)."""
    global _default_aligner
    if _default_aligner is None:
        if torch.cuda.device_count() > 1:
            from ..parallel.mesh import MeshAligner
            _default_aligner = MeshAligner()
        else:
            _default_aligner = WavefrontAligner(device="cuda")
    return _default_aligner


class AlnStats:
    """Stats-only stand-in for ``Alignment`` used by the native
    full-region align path (``native.cc sedef_fast_align``): carries the
    CIGAR and the tallies ``Hit.to_bed`` needs, without materializing
    gapped strings the native core already consumed."""

    __slots__ = ("cigar", "_matches", "_mismatches", "_gaps", "_gap_bases",
                 "_span")

    def __init__(self, cigar: list[tuple[str, int]], matches: int,
                 mismatches: int, gap_bases: int):
        self.cigar = cigar
        self._matches = matches
        self._mismatches = mismatches
        self._gap_bases = gap_bases
        self._gaps = sum(1 for op, _ in cigar if op != "M")
        self._span = sum(ln for _, ln in cigar)

    def span(self) -> int:
        return self._span

    def matches(self) -> int:
        return self._matches

    def mismatches(self) -> int:
        return self._mismatches

    def gaps(self) -> int:
        return self._gaps

    def gap_bases(self) -> int:
        return self._gap_bases

    def _err_denom(self) -> int:
        return self._matches + self._gap_bases + self._mismatches

    def gap_error(self) -> float:
        d = self._err_denom()
        return 100.0 * self._gap_bases / d if d else 0.0

    def mismatch_error(self) -> float:
        d = self._err_denom()
        return 100.0 * self._mismatches / d if d else 0.0

    def total_error(self) -> float:
        return self.mismatch_error() + self.gap_error()

    def cigar_string(self) -> str:
        return "".join(f"{ln}{op}" for op, ln in self.cigar if ln)


class Alignment:
    """Local-coordinate alignment of string ``a`` against string ``b``."""

    __slots__ = ("start_a", "end_a", "start_b", "end_b", "a", "b",
                 "cigar", "align_a", "align_b", "alignment",
                 "_matches", "_mismatches", "_gaps", "_gap_bases")

    def __init__(self):
        self.start_a = self.end_a = self.start_b = self.end_b = 0
        self.a = ""
        self.b = ""
        self.cigar: list[tuple[str, int]] = []
        self.align_a = self.align_b = self.alignment = ""
        self._matches = self._mismatches = 0
        self._gaps = self._gap_bases = 0

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_seqs(cls, fa: str, fb: str,
                  aligner: WavefrontAligner | None = None) -> "Alignment":
        """Global alignment via the wavefront kernel (align.cc:76-88)."""
        al = cls()
        al.a, al.b = fa, fb
        al.end_a, al.end_b = len(fa), len(fb)
        if aligner is None:
            aligner = default_aligner()
        al.cigar = aligner.align_strings(fa, fb)
        al.populate()
        return al

    @classmethod
    def from_cigar(cls, fa: str, fb: str, cigar_str: str) -> "Alignment":
        """Reconstruct from a CIGAR string (align.cc:90-105)."""
        al = cls()
        al.a, al.b = fa, fb
        al.end_a, al.end_b = len(fa), len(fb)
        # one regex pass over the string (the per-char isdigit loop was
        # ~20% of the stats stage); digits may be absent -> (op, 0),
        # ';' separators fall outside every match
        al.cigar = [(op, int(num) if num else 0)
                    for num, op in _CIGAR_RE.findall(cigar_str)]
        al.populate()
        return al

    @classmethod
    def from_anchors_many(cls, qstr: str, rstr: str, anchors: np.ndarray,
                          starts: np.ndarray,
                          aligner: WavefrontAligner | None = None
                          ) -> list["Alignment"]:
        """Stitch chains of exact-match anchors with aligned gaps
        (align.cc:199-270), every chain at once: chain ``c`` is the rows
        ``anchors[starts[c]:starts[c + 1]]`` (at least one), (q, r, len) in
        their first columns, in order along both strings.  Every chain's
        gap DP goes into ONE batched aligner call (the device-side win for
        stage 2b).

        A chain's CIGAR is the reference's ``append_cigar`` of each gap's
        CIGAR and then of the next anchor's ``M`` run, done in one pass
        over arrays: an appended CIGAR's first op merges into the op before
        it where the two are the same op, and no other op merges.  So a
        DP's trailing ``I`` and a big gap's ``I`` stay two ops, and a big
        gap's zero-length indel stays in the CIGAR and keeps the next
        anchor's ``M`` from merging."""
        if aligner is None:
            aligner = default_aligner()
        q, r, ln = anchors[:, :3].T.astype(np.int64)
        starts = np.asarray(starts, dtype=np.int64)
        m = len(q)
        if not m:
            return []
        # every anchor but a chain's first has a gap before it
        lead = np.zeros(m, dtype=bool)
        lead[starts[:-1]] = True
        gi = np.flatnonzero(~lead)
        qpe, rpe = q[gi - 1] + ln[gi - 1], r[gi - 1] + ln[gi - 1]
        qgap, rgap = q[gi] - qpe, r[gi] - rpe
        assert (np.minimum(qgap, rgap) >= 0).all()
        dp, big, jobs = _gap_jobs(qstr, rstr, qpe, rpe, qgap, rgap)
        ndp, fops, flens = cigar_runs(aligner.align_batch(jobs) if len(jobs)
                                      else [])

        # the ops, in order: each anchor's block is the gap before it (its
        # DP's ops and a big gap's indel, or one one-sided indel), then
        # its M run; ``head`` marks the first op of each appended CIGAR
        side = ~dp & ((qgap > 0) | (rgap > 0))
        gcnt = side.astype(np.int64)
        gcnt[dp] = ndp + big[dp]
        end = np.ones(m, dtype=np.int64)
        end[gi] += gcnt
        np.cumsum(end, out=end)
        total = int(end[-1])
        ops = np.empty(total, dtype=np.uint8)
        lens = np.empty(total, dtype=np.int32)
        head = np.zeros(total, dtype=bool)
        ops[end - 1] = _M
        lens[end - 1] = ln
        head[end - 1] = True
        go = end[gi - 1]  # each gap's first op
        head[go[gcnt > 0]] = True
        gs = go[side]
        ops[gs] = np.where(qgap[side] > 0, _D, _I)
        lens[gs] = qgap[side] + rgap[side]
        if len(ndp):
            first = np.cumsum(ndp) - ndp
            pos = (np.repeat(go[dp] - first, ndp)
                   + np.arange(len(fops), dtype=np.int64))
            ops[pos] = fops
            lens[pos] = flens
            bq, br = qgap[big], rgap[big]
            pos = go[big] + ndp[big[dp]]
            ops[pos] = np.where(bq <= br, _I, _D)
            lens[pos] = np.abs(bq - br)

        # junction merges: a head op joins the op before it where both are
        # the same op (a merge keeps the op, so "the op before" is the
        # previous flat op); a chain's first M opens its CIGAR
        new = ~head
        new[1:] |= ops[1:] != ops[:-1]
        new[0] = True
        new[end[lead] - 1] = True
        run = np.flatnonzero(new)
        rops = ops[run]
        rlens = np.add.reduceat(lens, run, dtype=np.int32)
        rb = np.searchsorted(run, end[starts[:-1]] - 1).tolist() + [len(run)]
        ops_s = rops.tobytes().decode("ascii")
        lens_l = rlens.tolist()
        last = starts[1:] - 1

        out: list[Alignment] = []
        for qs, qe, rs, re_, a, b in zip(
                q[starts[:-1]].tolist(), (q[last] + ln[last]).tolist(),
                r[starts[:-1]].tolist(), (r[last] + ln[last]).tolist(),
                rb, rb[1:]):
            al = cls()
            al.start_a, al.end_a = qs, qe
            al.start_b, al.end_b = rs, re_
            al.a = qstr[qs:qe]
            al.b = rstr[rs:re_]
            al.cigar = list(zip(ops_s[a:b], lens_l[a:b]))
            al._populate(rops[a:b], rlens[a:b])
            out.append(al)
        return out

    @classmethod
    def from_guide(cls, qstr: str, rstr: str, guide: list["Alignment"],
                   side: int,
                   aligner: WavefrontAligner | None = None) -> "Alignment":
        """Join sub-alignments with aligned gaps plus trimmed side extensions
        (align.cc:107-197).  ``guide`` alignments are in the same local
        coordinate system."""
        if aligner is None:
            aligner = default_aligner()
        al = guide[0].copy()
        # plan gaps between consecutive guide blocks, batch-align, stitch
        gaps = []
        pe_a, pe_b = al.end_a, al.end_b
        for cur in guide[1:]:
            assert pe_a <= cur.start_a and pe_b <= cur.start_b
            gaps.append((pe_a, cur.start_a, pe_b, cur.start_b))
            pe_a, pe_b = cur.end_a, cur.end_b
        gap_cigars = _batch_gap_cigars(qstr, rstr, gaps, aligner)
        for cur, gc in zip(guide[1:], gap_cigars):
            qs, qe = cur.start_a, cur.end_a
            rs, re = cur.start_b, cur.end_b
            qpe, rpe = al.end_a, al.end_b
            al.end_a = qe
            al.end_b = re
            al.a += qstr[qpe:qe]
            al.b += rstr[rpe:re]
            al.append_cigar(gc)
            al.append_cigar(cur.cigar)
        qlo, qhi = al.start_a, al.end_a
        rlo, rhi = al.start_b, al.end_b

        if side:
            qlo_n = max(0, qlo - side)
            rlo_n = max(0, rlo - side)
            if qlo - qlo_n and rlo - rlo_n:
                gap = Alignment.from_seqs(qstr[qlo_n:qlo], rstr[rlo_n:rlo],
                                          aligner)
                gap.trim_front()
                qlo_n = qlo - (gap.end_a - gap.start_a)
                rlo_n = rlo - (gap.end_b - gap.start_b)
                al.prepend_cigar(gap.cigar)
                al.a = qstr[qlo_n:qlo] + al.a
                al.b = rstr[rlo_n:rlo] + al.b
                al.start_a = qlo = qlo_n
                al.start_b = rlo = rlo_n
            qhi_n = min(qhi + side, len(qstr))
            rhi_n = min(rhi + side, len(rstr))
            if qhi_n - qhi and rhi_n - rhi:
                gap = Alignment.from_seqs(qstr[qhi:qhi_n], rstr[rhi:rhi_n],
                                          aligner)
                gap.trim_back()
                qhi_n = qhi + gap.end_a
                rhi_n = rhi + gap.end_b
                al.append_cigar(gap.cigar)
                al.a += qstr[qhi:qhi_n]
                al.b += rstr[rhi:rhi_n]
                al.end_a = qhi = qhi_n
                al.end_b = rhi = rhi_n
        al.populate()
        return al

    def copy(self) -> "Alignment":
        o = Alignment()
        for s in self.__slots__:
            setattr(o, s, getattr(self, s))
        o.cigar = list(self.cigar)
        return o

    # -- derived state ------------------------------------------------------

    def populate(self) -> None:
        """Rebuild gapped strings and error tallies (align.cc:274-315)."""
        self._populate(
            np.frombuffer("".join(op for op, _ in self.cigar).encode("ascii"),
                          dtype=np.uint8),
            np.array([ln for _, ln in self.cigar], dtype=np.int32))

    def _populate(self, ops: np.ndarray, lens: np.ndarray) -> None:
        """:meth:`populate` from the CIGAR as arrays: its ops' codes
        (uint8) and lengths (int32)."""
        gap = ops != _M
        self._gaps = int(gap.sum())
        self._gap_bases = int(lens[gap].sum())
        try:
            from ..native import lib as _native
        except Exception:  # pragma: no cover
            _native = None
        if _native is not None and _native.has("populate"):
            # one native pass (parity-tested vs the numpy path below —
            # the per-op numpy slicing + string codecs cost ~0.4 ms per
            # dense region, measured r5)
            ga, gb, mid, m, mm = _native.populate(
                self.a.encode("ascii"), self.b.encode("ascii"), ops, lens)
            self.align_a = ga.decode("ascii")
            self.align_b = gb.decode("ascii")
            self.alignment = mid.decode("ascii")
            self._matches = m
            self._mismatches = mm
            return
        a_arr = np.frombuffer(self.a.encode("ascii"), dtype=np.uint8)
        b_arr = np.frombuffer(self.b.encode("ascii"), dtype=np.uint8)
        total = int(lens.sum())
        ga = np.empty(total, dtype=np.uint8)
        gb = np.empty(total, dtype=np.uint8)
        ia = ib = pos = 0
        for op, ln in zip(ops.tolist(), lens.tolist()):
            if op == _M:
                ga[pos:pos + ln] = a_arr[ia:ia + ln]
                gb[pos:pos + ln] = b_arr[ib:ib + ln]
                ia += ln
                ib += ln
            elif op == _D:
                ga[pos:pos + ln] = a_arr[ia:ia + ln]
                gb[pos:pos + ln] = _DASH
                ia += ln
            else:  # 'I'
                ga[pos:pos + ln] = _DASH
                gb[pos:pos + ln] = b_arr[ib:ib + ln]
                ib += ln
            pos += ln
        eq = _ceq_arrays(ga, gb)
        self.align_a = ga.tobytes().decode("ascii")
        self.align_b = gb.tobytes().decode("ascii")
        self.alignment = np.where(eq, np.uint8(124), np.uint8(42)
                                  ).tobytes().decode("ascii")  # '|' / '*'
        both = (ga != _DASH) & (gb != _DASH)
        self._matches = int((both & eq).sum())
        self._mismatches = int((both & ~eq).sum())

    # -- getters (align.h:78-92) -------------------------------------------

    def span(self) -> int:
        return len(self.alignment)

    def matches(self) -> int:
        return self._matches

    def mismatches(self) -> int:
        return self._mismatches

    def gaps(self) -> int:
        return self._gaps

    def gap_bases(self) -> int:
        return self._gap_bases

    def _err_denom(self) -> int:
        return self._matches + self._gap_bases + self._mismatches

    def gap_error(self) -> float:
        d = self._err_denom()
        return 100.0 * self._gap_bases / d if d else 0.0

    def mismatch_error(self) -> float:
        d = self._err_denom()
        return 100.0 * self._mismatches / d if d else 0.0

    def total_error(self) -> float:
        return self.mismatch_error() + self.gap_error()

    def cigar_string(self) -> str:
        return "".join(f"{ln}{op}" for op, ln in self.cigar if ln)

    def pretty(self, width: int = 100, only_alignment: bool = False) -> str:
        """Human-readable block rendering (align.cc:638-677 ``print``; no
        call sites in the reference either — a debug utility).  Header with
        spans/error tallies, then the gapped strings in ``width`` columns
        with running coordinates."""
        assert self.alignment
        res = ""
        qa, sa = self.start_a, 0
        qb, sb = self.start_b, 0
        if width == -1:
            width = len(self.alignment)
        if not only_alignment:
            res += (
                "       A: {:>9}..{:<9} (len {:7})    Gaps:       {:5}"
                " = {:.0f}% ({})\n"
                "       B: {:>9}..{:<9} (len {:7})    Mismatches: {:5}"
                " = {:.0f}%\n"
                "   CIGAR: {}\n").format(
                self.start_a, self.end_a, self.end_a - self.start_a,
                self._gap_bases, self.gap_error(), self._gaps,
                self.start_b, self.end_b, self.end_b - self.start_b,
                self._mismatches, self.mismatch_error(),
                self.cigar_string())
        for i in range(0, len(self.alignment), width):
            wa = self.align_a[i:i + width]
            wm = self.alignment[i:i + width]
            wb = self.align_b[i:i + width]
            if only_alignment:
                res += f"{wa}\n{wm}\n{wb}\n\n"
            else:
                res += ("   {:10}: {} {}\n   {:10}  {} {}\n"
                        "   {:10}: {} {}\n").format(
                    qa, wa, sa, "", wm, i + len(wa), qb, wb, sb)
            qa += sum(1 for c in wa if c != "-")
            sa += sum(1 for c in wa if c != "-")
            qb += sum(1 for c in wb if c != "-")
            sb += sum(1 for c in wb if c != "-")
        return res

    # -- CIGAR surgery ------------------------------------------------------

    def prepend_cigar(self, app: list[tuple[str, int]]) -> None:
        if not app:
            return
        if self.cigar and self.cigar[0][0] == app[-1][0]:
            self.cigar[0] = (self.cigar[0][0],
                             self.cigar[0][1] + app[-1][1])
            self.cigar = list(app[:-1]) + self.cigar
        else:
            self.cigar = list(app) + self.cigar

    def append_cigar(self, app: list[tuple[str, int]]) -> None:
        if not app:
            return
        if self.cigar and self.cigar[-1][0] == app[0][0]:
            self.cigar[-1] = (self.cigar[-1][0],
                              self.cigar[-1][1] + app[0][1])
            self.cigar += list(app[1:])
        else:
            self.cigar += list(app)

    def cigar_from_alignment(self) -> None:
        """Recompute the CIGAR from the gapped strings (align.cc:480-501),
        vectorized run-length encoding.

        Empty alignments yield the reference's ``{'\\0', 0}`` sentinel op
        (align.cc:501 pushes the initial ``op=0, sz=0`` run unconditionally).
        The sentinel is invisible in ``cigar_string`` but blocks junction
        coalescing in later ``append_cigar``/``prepend_cigar`` calls —
        observable as adjacent uncoalesced runs (e.g. ``58M62M``) when a
        fully-trimmed mate is appended during ``merge``."""
        n = len(self.align_a)
        if n == 0:
            self.cigar = [("\x00", 0)]
            return
        ga = np.frombuffer(self.align_a.encode(), np.uint8)
        gb = np.frombuffer(self.align_b.encode(), np.uint8)
        ops = np.where(ga == _DASH, np.uint8(ord("I")),
                       np.where(gb == _DASH, np.uint8(ord("D")),
                                np.uint8(ord("M"))))
        starts = np.concatenate([[0], np.nonzero(ops[1:] != ops[:-1])[0] + 1])
        ends = np.concatenate([starts[1:], [n]])
        self.cigar = [(chr(ops[st]), int(en - st))
                      for st, en in zip(starts, ends)]

    def swap(self) -> None:
        """Swap mates, flipping I<->D (align.cc:623-636).  Zero-length ops
        keep their char — the reference flips only ``if (p.second)``, so a
        zero filler/sentinel survives a swap unflipped (affects whether a
        later same-op append merges into it)."""
        self.a, self.b = self.b, self.a
        self.start_a, self.start_b = self.start_b, self.start_a
        self.end_a, self.end_b = self.end_b, self.end_a
        self.cigar = [("D" if op == "I" else ("I" if op == "D" else op), ln)
                      if ln else (op, ln) for op, ln in self.cigar]
        self.populate()

    # -- trimming (align.cc:317-456) ---------------------------------------

    def trim(self) -> None:
        """Strip leading/trailing indels (align.cc:317-341)."""
        while self.cigar:
            op, ln = self.cigar[0]
            if op == "D":
                self.a = self.a[ln:]
                self.start_a += ln
                self.cigar.pop(0)
            elif op == "I":
                self.b = self.b[ln:]
                self.start_b += ln
                self.cigar.pop(0)
            elif self.cigar[-1][0] == "D":
                ln2 = self.cigar[-1][1]
                self.end_a -= ln2
                self.a = self.a[:len(self.a) - ln2]
                self.cigar.pop()
            elif self.cigar[-1][0] == "I":
                ln2 = self.cigar[-1][1]
                self.end_b -= ln2
                self.b = self.b[:len(self.b) - ln2]
                self.cigar.pop()
            else:
                break
        self.populate()

    def _column_scores(self, cfg: Config, forward: bool) -> np.ndarray:
        """Per-column score contributions with gap opens charged at the
        run edge the scan direction encounters rules for (align.cc:343-421)."""
        n = len(self.alignment)
        ga = np.frombuffer(self.align_a.encode(), dtype=np.uint8)
        gb = np.frombuffer(self.align_b.encode(), dtype=np.uint8)
        is_match = np.frombuffer(self.alignment.encode(),
                                 dtype=np.uint8) == 124
        gap_a = ga == _DASH
        gap_b = gb == _DASH
        is_gap = gap_a | gap_b
        sc = np.where(is_match, cfg.align.match,
                      np.where(~is_gap, cfg.align.mismatch,
                               cfg.align.gap_extend)).astype(np.int64)
        if forward:
            # trim_back scan: open at i==0 or run start vs i-1
            opens = np.zeros(n, dtype=bool)
            if n:
                opens[0] = is_gap[0]
                opens[1:] = ((gap_a[1:] & ~gap_a[:-1])
                             | (gap_b[1:] & ~gap_b[:-1]))
            opens &= is_gap
        else:
            # trim_front scan: open at i==n-1 or run end vs i+1
            opens = np.zeros(n, dtype=bool)
            if n:
                opens[-1] = is_gap[-1]
                opens[:-1] = ((gap_a[:-1] & ~gap_a[1:])
                              | (gap_b[:-1] & ~gap_b[1:]))
            opens &= is_gap
        sc = sc + np.where(opens, cfg.align.gap_open, 0)
        return sc

    def trim_front(self, cfg: Config = DEFAULT) -> None:
        """Keep the max-scoring suffix (align.cc:343-398).

        Reference quirk reproduced: align.cc:345 initializes the
        "trim everything" sentinel to ``max_i = a.size()``, but max_i
        stores a GAPPED column index — when the optimal cut lands exactly
        at column a.size() (possible whenever the alignment contains
        gaps), the sentinel collides with a legitimate answer and the
        whole suffix is discarded despite a positive score.  trim_back's
        sentinel is -1 and cannot collide."""
        n = len(self.alignment)
        sc = self._column_scores(cfg, forward=False)
        rcum = np.cumsum(sc[::-1])[::-1] if n else np.empty(0, np.int64)
        gm = rcum.max() if n else -1
        max_i = int(np.nonzero(rcum == gm)[0][0]) if n and gm >= 0 else -1
        if n == 0 or gm < 0 or max_i == len(self.a):
            self.a = ""
            self.b = ""
            self.start_a = self.end_a
            self.start_b = self.end_b
            self.cigar = []
            self.populate()
            return
        # cigar surgery (align.cc:374-397)
        cur_len = 0
        ci = 0
        while ci < len(self.cigar):
            op, ln = self.cigar[ci]
            if ln + cur_len > max_i:
                assert op == "M"
                need = max_i - cur_len
                self.cigar[ci] = (op, ln - need)
                del self.cigar[:ci]
                self.start_a += need
                self.start_b += need
                break
            cur_len += ln
            if op == "M":
                self.start_a += ln
                self.start_b += ln
            elif op == "I":
                self.start_b += ln
            else:
                self.start_a += ln
            ci += 1
        self.a = self.a[len(self.a) - (self.end_a - self.start_a):]
        self.b = self.b[len(self.b) - (self.end_b - self.start_b):]
        self.populate()

    def trim_back(self, cfg: Config = DEFAULT) -> None:
        """Keep the max-scoring prefix (align.cc:400-456)."""
        n = len(self.alignment)
        sc = self._column_scores(cfg, forward=True)
        cum = np.cumsum(sc) if n else np.empty(0, np.int64)
        if n == 0 or cum.max() < 0:
            self.a = ""
            self.b = ""
            self.end_a = self.start_a
            self.end_b = self.start_b
            self.cigar = []
            self.populate()
            return
        gm = cum.max()
        max_i = int(np.nonzero(cum == gm)[0][-1]) + 1  # rightmost (ties)
        self.end_a, self.end_b = self.start_a, self.start_b
        cur_len = 0
        ci = 0
        while ci < len(self.cigar):
            op, ln = self.cigar[ci]
            if ln + cur_len >= max_i:
                assert op == "M"
                need = max_i - cur_len
                self.cigar[ci] = (op, need)
                del self.cigar[ci + 1:]
                self.end_a += need
                self.end_b += need
                break
            cur_len += ln
            if op == "M":
                self.end_a += ln
                self.end_b += ln
            elif op == "I":
                self.end_b += ln
            else:
                self.end_a += ln
            ci += 1
        self.a = self.a[:self.end_a - self.start_a]
        self.b = self.b[:self.end_b - self.start_b]
        self.populate()

    # -- merging (align.cc:505-610) ----------------------------------------

    def merge(self, cur: "Alignment", qstr: str, rstr: str,
              aligner: WavefrontAligner | None = None) -> None:
        """Merge an overlapping later alignment into this one
        (align.cc:505-610): back-trim self / front-trim ``cur`` by the
        a-overlap then the b-overlap, re-derive CIGARs, align the residual
        gap, concatenate."""
        if aligner is None:
            aligner = default_aligner()
        assert cur.start_a < self.end_a or cur.start_b < self.end_b
        assert self.end_a <= cur.end_a and self.end_b <= cur.end_b
        def _nongaps(al):
            ga = np.frombuffer(al.align_a.encode(), np.uint8) != _DASH
            gb = np.frombuffer(al.align_b.encode(), np.uint8) != _DASH
            return ga, gb

        def cut_self(trim: int, key: str) -> None:
            # vectorized: pos = column where the trim-th keyed non-gap from
            # the END is consumed (align.cc:511-525 scan semantics)
            ga, gb = _nongaps(self)
            if trim > 0:
                keyarr = ga if key == "a" else gb
                idx = np.nonzero(keyarr)[0]
                pos = int(idx[len(idx) - trim]) if trim <= len(idx) else 0
                q = int(ga[pos:].sum())
                r = int(gb[pos:].sum())
            else:
                pos = len(self.alignment)
                q = r = 0
            self.align_a = self.align_a[:pos]
            self.alignment = self.alignment[:pos]
            self.align_b = self.align_b[:pos]
            self.end_a = self.start_a + len(self.a) - q
            self.end_b = self.start_b + len(self.b) - r
            self.a = self.a[:len(self.a) - q]
            self.b = self.b[:len(self.b) - r]

        def cut_cur(trim: int, key: str) -> None:
            ga, gb = _nongaps(cur)
            if trim > 0:
                keyarr = ga if key == "a" else gb
                idx = np.nonzero(keyarr)[0]
                pos = int(idx[trim - 1]) + 1 if trim <= len(idx) \
                    else len(cur.alignment)
                q = int(ga[:pos].sum())
                r = int(gb[:pos].sum())
            else:
                pos = 0
                q = r = 0
            cur.align_a = cur.align_a[pos:]
            cur.alignment = cur.alignment[pos:]
            cur.align_b = cur.align_b[pos:]
            cur.start_a += q
            cur.start_b += r
            cur.a = cur.a[q:]
            cur.b = cur.b[r:]

        trim = self.end_a - cur.start_a
        cut_self(trim, "a")
        cut_cur(trim, "a")
        trim = self.end_b - cur.start_b
        cut_self(trim, "b")
        cut_cur(trim, "b")

        self.cigar_from_alignment()
        cur.cigar_from_alignment()

        assert self.start_a <= cur.start_a and self.start_b <= cur.start_b
        assert self.end_a <= cur.start_a and self.end_b <= cur.start_b
        _append_gap_cigar(self, qstr, rstr, self.end_a, cur.start_a,
                          self.end_b, cur.start_b, aligner)
        qgap = cur.start_a - self.end_a
        rgap = cur.start_b - self.end_b
        self.a += qstr[self.end_a:self.end_a + qgap] + cur.a
        self.b += rstr[self.end_b:self.end_b + rgap] + cur.b
        self.end_a = cur.end_a
        self.end_b = cur.end_b
        self.append_cigar(cur.cigar)
        self.populate()


def _append_gap_cigar(al: Alignment, qstr: str, rstr: str, qpe: int, qs: int,
                      rpe: int, rs: int, aligner: WavefrontAligner) -> None:
    """Gap joining policy between consecutive blocks (align.cc:126-145,
    232-251, 579-600): small double-gaps get a full DP; large ones become
    one indel plus a same-length DP (the reference's comparison of the two
    candidates is a no-op — ``ma2.total_error() < ma2.total_error()`` —
    so candidate ``ma1`` always wins; reproduced)."""
    qgap, rgap = qs - qpe, rs - rpe
    if qgap and rgap:
        if qgap <= 1000 and rgap <= 1000:
            gap = Alignment.from_seqs(qstr[qpe:qs], rstr[rpe:rs], aligner)
            al.append_cigar(gap.cigar)
        else:
            ma = max(qgap, rgap)
            mi = min(qgap, rgap)
            ma1 = Alignment.from_seqs(qstr[qpe:qpe + mi], rstr[rpe:rpe + mi],
                                      aligner)
            ma1.cigar.append(("I" if qgap == mi else "D", ma - mi))
            al.append_cigar(ma1.cigar)
    elif qgap:
        al.append_cigar([("D", qgap)])
    elif rgap:
        al.append_cigar([("I", rgap)])
