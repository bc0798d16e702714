"""The port's device roll engine (``sedef_tpu_torch.ops.roll_engine``)
against the reference package's (``sedef_tpu.ops.roll_engine``, JAX on the
CPU) and against the port's scalar ``SlidingJaccard`` roll, and the
device-roll ``initial_search`` against the host route and ``sedef_tpu``'s
seeds; the port runs on the CPU device with batches smaller than the
card's 1,024.  Tolerance: exact equality, values and dtypes (integer
jaccards and step counts; seeds byte for byte)."""

import numpy as np
import pytest
import torch

from sedef_tpu.models import seeder as ref_seeder
from sedef_tpu.ops import dna as ref_dna
from sedef_tpu.ops import roll_engine as ref_re
from sedef_tpu.ops.index import MinimizerIndex as RefIndex
from sedef_tpu_torch.config import DEFAULT
from sedef_tpu_torch.models import seeder
from sedef_tpu_torch.native import lib as native
from sedef_tpu_torch.ops import dna
from sedef_tpu_torch.ops import roll_engine as re_
from sedef_tpu_torch.ops.index import MinimizerIndex
from sedef_tpu_torch.ops.sliding import SlidingJaccard
from sedef_tpu_torch.ops.stat_model import relaxed_jaccard_estimate

torch.set_num_threads(1)


def scalar_roll(qh, rh, qws, qwe, t_start, t_end, init_len, cfg):
    """The roll of search_in_reference_interval on the query window
    [qws, qwe) with the port's scalar sketch: (best_j, best_steps)."""
    w = SlidingJaccard(qh.kmer_size, cfg)
    for i in range(qws, qwe):
        w.add_to_query(int(qh.keys[i]))
    rlen = len(rh.seq)
    nr = len(rh.keys)
    rs = t_start
    re = min(t_start + init_len, rlen)
    rws = rh.find_minimizers(rs)
    rwe = rws
    while rwe < nr and rh.locs[rwe] < re:
        w.add_to_reference(int(rh.keys[rwe]))
        rwe += 1
    best = (w.jaccard(), 0)
    steps = 0
    while rs < t_end and re < rlen:
        if rws < nr and rh.locs[rws] < rs + 1:
            w.remove_from_reference(int(rh.keys[rws]))
            rws += 1
        if rwe < nr and rh.locs[rwe] == re:
            w.add_to_reference(int(rh.keys[rwe]))
            rwe += 1
        steps += 1
        if w.jaccard() > best[0]:
            best = (w.jaccard(), steps)
        rs += 1
        re += 1
        if re == rlen:
            break
    return best


def mutate(seq, rate, rng):
    out = []
    for ch in seq:
        r = rng.random()
        if r < rate * 0.7:
            out.append(rng.choice(list("ACGT")))
        elif r < rate * 0.85:
            pass  # deletion
        elif r < rate:
            out.append(ch)
            out.append(rng.choice(list("ACGT")))
        else:
            out.append(ch)
    return "".join(out)


def lut(k, cfg=DEFAULT):
    return np.array([relaxed_jaccard_estimate(s, k, cfg)
                     for s in range(161)], np.int32)


def plan_columns(qh, rh, same=False, cfg=DEFAULT):
    """The native speculative plan as RollEngine.run's columns."""
    win, iv = native.search_plan(qh, rh, same, cfg)
    woff = np.repeat(np.arange(len(win)), win[:, 3])
    return (win[woff, 1], win[woff, 2], iv[:, 0], iv[:, 2], iv[:, 3],
            iv[:, 4], iv[:, 5]), iv[:, 1]


def _indexes(q, r, k=12, w=16, rc=False):
    return (MinimizerIndex(dna.PackedSeq("q", q), k, w),
            MinimizerIndex(dna.PackedSeq("r", r, is_rc=rc), k, w))


def _run_both(qh, rh, cols, batch, W=re_.DEFAULT_W, SQ=re_.DEFAULT_SQ):
    """(port's run on the CPU, reference's run) on the same plan."""
    k = qh.kmer_size
    eng = re_.RollEngine(k, lut(k), W=W, SQ=SQ, batch=batch)
    qk, _ = qh.device_arrays("cpu")
    rk, rl = rh.device_arrays("cpu")
    got = eng.run(qk, rk, rl, len(rh.keys), len(rh.seq), *cols)
    ref = ref_re.RollEngine(k, lut(k), W=W, SQ=SQ, batch=batch)
    want = ref.run(qh.keys.astype(np.int32), rh.keys.astype(np.int32),
                   rh.locs.astype(np.int32), len(rh.keys), len(rh.seq),
                   *cols)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_)
    return got


needs_native = pytest.mark.skipif(not native.has("search_plan"),
                                  reason="native library not built")


@needs_native
@pytest.mark.parametrize("seed,rate", [(0, 0.05), (1, 0.12), (2, 0.25)])
def test_roll_engine_matches_reference_and_scalar(seed, rate):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(list("ACGT"), 1500))
    q = "".join(rng.choice(list("ACGT"), 400)) + base + \
        "".join(rng.choice(list("ACGT"), 400))
    r = "".join(rng.choice(list("ACGT"), 600)) + mutate(base, rate, rng) + \
        "".join(rng.choice(list("ACGT"), 600))
    qh, rh = _indexes(q, r)
    cols, t1 = plan_columns(qh, rh)
    assert len(t1), "no intervals planned - test setup broken"
    bj, bs, ok = _run_both(qh, rh, cols, batch=16)
    init_len = DEFAULT.search.min_read_size
    for i in range(len(t1)):
        assert ok[i]
        assert (bj[i], bs[i]) == scalar_roll(
            qh, rh, int(cols[0][i]), int(cols[1][i]), int(cols[2][i]),
            int(t1[i]), init_len, DEFAULT), i


@needs_native
def test_roll_engine_masked_and_n():
    """Soft-masked + N-run sequences: the HAS_N skip (ref keys never
    added) and lowercase statuses through the packed store."""
    rng = np.random.default_rng(9)
    chars = list("ACGTacgt")
    base = "".join(rng.choice(chars, 1800))
    q = "".join(rng.choice(chars, 300)) + base + "N" * 30 + base[:400]
    r = ("".join(rng.choice(chars, 500)) + mutate(base, 0.1, rng)
         + "N" * 30 + mutate(base[:400], 0.1, rng))
    qh, rh = _indexes(q, r)
    cols, t1 = plan_columns(qh, rh)
    assert len(t1)
    bj, bs, ok = _run_both(qh, rh, cols, batch=8)
    assert ok.all()
    init_len = DEFAULT.search.min_read_size
    for i in range(0, len(t1), max(1, len(t1) // 12)):
        assert (bj[i], bs[i]) == scalar_roll(
            qh, rh, int(cols[0][i]), int(cols[1][i]), int(cols[2][i]),
            int(t1[i]), init_len, DEFAULT), i


@needs_native
def test_roll_batch_classes_and_overflow():
    """``_roll_batch`` against the reference's in both T classes, with an
    interval of the 4,096 class, one past the ladder (host: ok False), a
    window past SQ keys and a sketch past W entries (ok False)."""
    rng = np.random.default_rng(4)
    base = "".join(rng.choice(list("ACGT"), 1400))
    q = base + "".join(rng.choice(list("ACGT"), 300))
    r = ("".join(rng.choice(list("ACGT"), 5200)) + mutate(base, 0.08, rng)
         + "".join(rng.choice(list("ACGT"), 300)))
    qh, rh = _indexes(q, r)
    cols, t1 = plan_columns(qh, rh)
    assert len(t1)
    i0 = 0
    rows = [list(c[i0:i0 + 1]) for c in cols]
    # the same window rolled from the ref's start: 4,096 class, and past it
    for n_steps in (4000, 4500):
        t0 = 0
        vals = [cols[0][i0], cols[1][i0], t0, rh.find_minimizers(t0), 0,
                n_steps, DEFAULT.search.min_read_size]
        rws0 = int(vals[3])
        vals[4] = int(np.searchsorted(rh.locs, t0 + vals[6])) - rws0
        for c, v in zip(rows, vals):
            c.append(v)
    cols2 = tuple(np.asarray(c, np.int32) for c in rows)
    assert re_._t_classes(cols2[5]).tolist() == [
        re_._t_classes(cols[5][i0:i0 + 1])[0], 4096, 0]
    bj, bs, ok = _run_both(qh, rh, cols2, batch=4)
    assert ok.tolist() == [True, True, False]
    init_len = DEFAULT.search.min_read_size
    assert (bj[1], bs[1]) == scalar_roll(
        qh, rh, int(cols2[0][1]), int(cols2[1][1]), 0, 4000, init_len,
        DEFAULT)
    # capacities: a store of 64 entries overflows on the roll through
    # unrelated sequence (row 1), and a window of more than SQ = 16 keys
    _, _, ok_w = _run_both(qh, rh, cols2, batch=4, W=64, SQ=48)
    assert not ok_w[1]
    _, _, ok_q = _run_both(qh, rh, cols2, batch=4, W=64, SQ=16)
    assert not ok_q.any()
    # the batch function itself, one class, every output's dtype
    dev = torch.device("cpu")
    qk, _ = qh.device_arrays(dev)
    rk, rl = rh.device_arrays(dev)
    args = [torch.from_numpy(c[:2].copy()) for c in cols2]
    got = re_._roll_batch(rk, rl, len(rh.keys), torch.from_numpy(lut(12)),
                          qk, *args, W=512, SQ=160, INIT_PAD=192,
                          T_PAD=4096, n_shift=24)
    want = ref_re._roll_batch(
        rh.keys.astype(np.int32), rh.locs.astype(np.int32),
        np.int32(len(rh.keys)), np.int32(len(rh.seq)), lut(12),
        qh.keys.astype(np.int32), *[c[:2] for c in cols2],
        W=512, SQ=160, INIT_PAD=192, T_PAD=4096, n_shift=24)
    for g, w_ in zip(got, want):
        assert g.numpy().dtype == np.asarray(w_).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_engine_refuses_wide_k():
    with pytest.raises(ValueError):
        re_.RollEngine(14, lut(12))


def _family_pair(rng, trial):
    def rand_seq(n, chars="ACGT"):
        return "".join(rng.choice(list(chars), n))

    fam = rand_seq(900)
    parts_q, parts_r = [], []
    for _ in range(8):
        parts_q.append(rand_seq(400, "acgt"))
        parts_q.append(mutate(fam, 0.03 * (trial % 3), rng))
        parts_r.append(rand_seq(300, "acgt"))
        parts_r.append(mutate(fam, 0.05 + 0.03 * (trial % 3), rng))
    q = "".join(parts_q)
    return q, (q if trial % 2 == 0 else "".join(parts_r))


@needs_native
@pytest.mark.parametrize("trial", range(4))
def test_device_roll_search_byte_identical(trial, monkeypatch):
    """initial_search with the roll engine forced on (on the CPU device)
    emits the host route's seeds and sedef_tpu's, including same-genome
    runs where hit-tree pruning sends windows back to the host roll."""
    rng = np.random.default_rng(100 + trial)
    q, r = _family_pair(rng, trial)
    same = trial % 2 == 0
    qh, rh = _indexes(q, r)
    host = [h.to_bed() for h in
            seeder.initial_search(qh, rh, same, DEFAULT, use_device=False)]
    ref = [h.to_bed() for h in ref_seeder.initial_search(
        RefIndex(ref_dna.PackedSeq("q", q), 12, 16),
        RefIndex(ref_dna.PackedSeq("r", r), 12, 16),
        same, ref_seeder.DEFAULT, use_device=False)]
    monkeypatch.setattr(seeder, "ROLL_DEVICE_MIN", 1)
    calls = []
    real = seeder._device_roll_results

    def spy(*a):
        calls.append(a[-1])
        return real(*a)

    monkeypatch.setattr(seeder, "_device_roll_results", spy)
    dev = [h.to_bed() for h in
           seeder.initial_search(qh, rh, same, DEFAULT, use_device="cpu")]
    assert calls and str(calls[0]) == "cpu"
    assert dev == host == ref
    assert len(host) > 0


@needs_native
def test_roll_engine_empty_query_window():
    """An interval whose query window is empty (qwe == qws: no query key,
    the boundary index starts at -1 and falls with every ref key inserted
    below it), in both T classes: the reference indexes the row from its
    end there, and the port gives its results."""
    rng = np.random.default_rng(4)
    base = "".join(rng.choice(list("ACGT"), 1400))
    q = base + "".join(rng.choice(list("ACGT"), 300))
    r = ("".join(rng.choice(list("ACGT"), 300)) + mutate(base, 0.08, rng))
    qh, rh = _indexes(q, r)
    cols, _ = plan_columns(qh, rh)
    assert len(cols[0])
    row = [int(c[0]) for c in cols]
    row[1] = row[0]  # qwe = qws
    assert re_._t_classes([row[5]])[0] == 4096
    short = list(row)
    short[5] = 500  # the same interval cut to the 512 class
    cols2 = tuple(np.asarray(c, np.int32) for c in zip(row, short))
    bj, bs, ok = _run_both(qh, rh, cols2, batch=4)
    assert (bj[0], bs[0], ok[0]) == (-33, 635, True)
    assert ok.all()


def _edge_batch(W=re_.DEFAULT_W, SQ=re_.DEFAULT_SQ):
    """The batch function's arguments on the edge rows of both T classes:
    plan rows of a pair with soft-masked bases and an N run (HAS_N ref
    keys), an empty query window in each class, a window of more than SQ
    keys, and rows past the ladder of the class they are batched in."""
    rng = np.random.default_rng(9)
    chars = list("ACGTacgt")
    base = "".join(rng.choice(chars, 1800))
    q = "".join(rng.choice(chars, 300)) + base + "N" * 30 + base[:400]
    r = ("".join(rng.choice(chars, 500)) + mutate(base, 0.1, rng)
         + "N" * 30 + mutate(base[:400], 0.1, rng))
    qh, rh = _indexes(q, r)
    cols, _ = plan_columns(qh, rh)
    rows = [[int(c[i]) for c in cols] for i in range(min(6, len(cols[0])))]
    # the N run's ref keys inside the initial window and the roll
    n_at = int(np.searchsorted(rh.locs, len(r) - 500 - DEFAULT.search
                               .min_read_size))
    n_row = list(rows[0])
    n_row[2], n_row[3] = int(rh.locs[n_at]), n_at
    n_row[4] = int(np.searchsorted(rh.locs, n_row[2] + n_row[6]
                                   - rows[0][2])) - n_at
    n_row[6] = n_row[2] + rows[0][6] - rows[0][2]
    n_row[5] = 300
    rows.append(n_row)
    for steps in (300, 3000):  # empty query windows
        e = list(rows[0])
        e[1], e[5] = e[0], steps
        rows.append(e)
    wide = list(rows[0])  # a window of more than SQ keys
    wide[1] = wide[0] + SQ + 5
    rows.append(wide)
    for steps in (600, 5000):  # past the 512 class, past the ladder
        e = list(rows[0])
        e[5] = steps
        rows.append(e)
    cols2 = tuple(np.asarray(c, np.int32) for c in zip(*rows))
    assert (rh.keys[n_at:n_at + n_row[4] + 50] >> 24 == 2).any()
    return qh, rh, cols2


def _batch_args(qh, rh, cols, dev="cpu"):
    qk, _ = qh.device_arrays(dev)
    rk, rl = rh.device_arrays(dev)
    return (rk, rl, len(rh.keys), torch.from_numpy(lut(12)).to(dev), qk,
            *[torch.from_numpy(c.copy()).to(dev) for c in cols])


@needs_native
@pytest.mark.parametrize("T_PAD", re_.T_PAD_LADDER)
def test_roll_batch_wrapper_on_cpu_is_plain_and_reference(T_PAD):
    """On CPU tensors ``_roll_batch`` is its plain version, and both equal
    the reference's jitted batch on the same edge rows, dtypes included;
    no kernel is launched."""
    qh, rh, cols = _edge_batch()
    args = _batch_args(qh, rh, cols)
    kw = dict(W=512, SQ=160, INIT_PAD=192, T_PAD=T_PAD, n_shift=24)
    before = re_._roll_batch.launches
    got = re_._roll_batch(*args, **kw)
    plain = re_._roll_batch_torch(*args, **kw)
    want = ref_re._roll_batch(
        rh.keys.astype(np.int32), rh.locs.astype(np.int32),
        np.int32(len(rh.keys)), np.int32(len(rh.seq)), lut(12),
        qh.keys.astype(np.int32), *cols, **kw)
    assert re_._roll_batch.launches == before
    for g, p, w_ in zip(got, plain, want):
        assert g.dtype == p.dtype and g.numpy().dtype == np.asarray(w_).dtype
        assert torch.equal(g, p)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    ok = got[2].numpy()
    assert ok.any() and not ok.all()


def test_roll_batch_refuses_other_devices():
    m = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        re_._roll_batch(m, m, 4, m, m, m, m, m, m, m, m, m, W=512, SQ=160,
                        INIT_PAD=192, T_PAD=512, n_shift=24)
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        re_._roll_batch(c, c, 4, c, c, c, c, c, c, c, c, m, W=512, SQ=160,
                        INIT_PAD=192, T_PAD=512, n_shift=24)


def roll_kernel_model(r_keys, r_locs, nr, limit_lut, q_keys, cols, W, SQ,
                      INIT_PAD, T_PAD, n_shift, stats=None):
    """``csrc/roll_engine.cu`` one interval (one warp) at a time in NumPy,
    as the kernel holds and moves its data:

    * the row as 32 lanes of E = W / 32 registers, lane-major (lane l:
      entries [E l, E l + E));
    * a key's place: each lane's E compares, summed over the lanes (the
      warp's ``__reduce_add_sync``);
    * an entry: the select tree on its index's bits in every lane, then
      the owning lane's value (``__shfl_sync``);
    * an insert or an erase: an E-wide shift in each lane with the carry
      from the lane below (``__shfl_up_sync``) or above
      (``__shfl_down_sync``, INF past the last), the carry taken before
      the search;
    * the boundary entry read from the row before the update (an add:
      row[Bp] where 0 <= Bp <= W - 2, after the update elsewhere);
    * the cursors as windows of 32 loci and keys, the next 32 loaded
      ahead and taking the window's place at its end;
    * phase B from change to change: the next step at which a cursor's
      test holds, from the locus at the cursor.

    ``stats`` (a dict) counts the cursors' window refills, the adds that
    read the boundary after the update, and the roll steps skipped."""
    INF, MIN, NEVER = 2**31 - 1, -2**31, 1 << 40
    E = W // 32
    lanes = np.arange(32)
    r_keys, r_locs, q_keys, limit_lut = (
        np.asarray(a, np.int64) for a in (r_keys, r_locs, q_keys, limit_lut))
    stats = {} if stats is None else stats
    for key in ("refills", "late_boundary", "skipped"):
        stats.setdefault(key, 0)

    def gather(a, i):
        return a[np.clip(i, 0, len(a) - 1)]

    def pick(r, i):  # the select tree on i's bits, in every lane
        t = r.copy()
        w = 1
        while w < E:
            for j in range(0, E, 2 * w):
                t[:, j] = t[:, j + w] if i & w else t[:, j]
            w *= 2
        return t[:, 0]

    def row_at(r, i):
        return int(pick(r, i & (E - 1))[i // E])

    def take1(r, i):
        i = min(i, W - 1)
        if i < 0:
            i += W
        v = row_at(r, max(i, 0))
        return MIN if i < 0 else v

    def lower_pos(r, h):
        if 0 <= h < 1 << 29:
            c = (r < h << 2).sum(axis=1)
        else:
            c = ((r >> 2) < h).sum(axis=1)
        return int(c.sum())

    def vadd(r, S, h, bit):
        carry = np.concatenate([r[:1, E - 1], r[:-1, E - 1]])
        inside = 0 <= S["Bp"] <= W - 2
        ob = row_at(r, S["Bp"] if inside else 0)
        pos = lower_pos(r, h)
        cur = row_at(r, min(pos, W - 1))
        d = pos - E * lanes
        exists = (cur >> 2) == h and pos < W
        flag_h = cur & 3 if exists else 0
        if exists and flag_h & bit:
            return
        if not exists and S["ln"] >= W:
            S["ovf"] = True
            return
        if exists:
            for j in range(E):
                r[:, j] = np.where(j == d, r[:, j] | bit, r[:, j])
        else:
            for j in reversed(range(E)):  # from the top: r[:, j - 1] old
                below = r[:, j - 1] if j else carry
                r[:, j] = np.where(j < d, r[:, j],
                                   np.where(j == d, h << 2 | bit, below))
            S["ln"] += 1
            if pos <= S["Bp"]:
                S["Bp"] += 1
        if inside:  # B's entry before the update: its key decides
            bcur = ob
        else:
            stats["late_boundary"] += 1
            bcur = take1(r, S["Bp"])
        if h < (bcur >> 2):
            if (flag_h | bit if exists else bit) == 3:
                S["inter"] += 1
            if not exists:
                S["inter"] -= (bcur & 3) == 3
                S["Bp"] -= 1

    def vremove(r, S, h, bit):
        carry = np.concatenate([r[1:, 0], [INF]])
        bcur = take1(r, S["Bp"])
        b2 = take1(r, S["Bp"] + 1)
        pos = lower_pos(r, h)
        cur = row_at(r, min(pos, W - 1))
        d = pos - E * lanes
        found = (cur >> 2) == h and pos < W
        flag_h = cur & 3 if found else 0
        if not (found and flag_h & bit):
            return
        erase = flag_h == bit
        if h <= (bcur >> 2):
            S["inter"] -= flag_h == 3
            if erase:
                S["Bp"] += 1
                S["inter"] += S["Bp"] < S["ln"] and (b2 & 3) == 3
        if erase:
            for j in range(E):  # from the bottom: r[:, j + 1] still old
                above = r[:, j + 1] if j < E - 1 else carry
                r[:, j] = np.where(j < d, r[:, j], above)
            S["ln"] -= 1
            if pos < S["Bp"]:
                S["Bp"] -= 1
        else:
            for j in range(E):
                r[:, j] = np.where(j == d, r[:, j] & ~bit, r[:, j])

    class Cursor:
        def __init__(self, start):
            self.c = self.base = start
            self.win = self.load(start)
            self.ahead = self.load(start + 32)

        @staticmethod
        def load(base):  # one coalesced load: lane i reads [base + i]
            return gather(r_locs, base + lanes), gather(r_keys, base + lanes)

        def at(self):  # (locus, key) by shuffle from lane c - base
            return (int(self.win[0][self.c - self.base]),
                    int(self.win[1][self.c - self.base]))

        def advance(self):
            self.c += 1
            if self.c - self.base == 32:
                self.win, self.base = self.ahead, self.base + 32
                self.ahead = self.load(self.base + 32)
                stats["refills"] += 1

    out = [[], [], []]
    for qws, qwe, t0, rws0, init_cnt, n_steps, re0 in zip(
            *[np.asarray(c).tolist() for c in cols]):
        keys = np.sort(np.where(qws + np.arange(SQ) < qwe,
                                gather(q_keys, qws + np.arange(SQ)), INF))
        keep = (keys != INF) & np.r_[True, keys[1:] != keys[:-1]]
        s = int(keep.sum())
        buf = np.full(W, INF, np.int64)
        buf[:s] = keys[keep] << 2 | 1
        r = buf.reshape(32, E)
        limit = int(limit_lut[min(s, len(limit_lut) - 1)])
        S = dict(ln=s, Bp=s - 1, inter=0, ovf=qwe - qws > SQ)
        cur = Cursor(rws0)
        for _ in range(min(init_cnt, INIT_PAD)):
            h = cur.at()[1]
            if h >> n_shift != 2:
                vadd(r, S, h, 2)
            cur.advance()

        def jac():
            return S["inter"] if S["inter"] >= limit else S["inter"] - limit

        best = (jac(), 0)
        n_roll = min(n_steps, T_PAD)
        R, A = Cursor(rws0), Cursor(rws0 + init_cnt)
        t = 0
        while True:
            (loc_r, h_r), (loc_a, h_a) = R.at(), A.at()
            tr = max(loc_r - t0, t) if R.c < nr else NEVER
            ta = loc_a - re0 if A.c < nr and loc_a - re0 >= t else NEVER
            stats["skipped"] += min(tr, ta, n_roll) - t
            t = min(tr, ta)
            if t >= n_roll:
                break
            if tr == t:
                if h_r >> n_shift != 2:
                    vremove(r, S, h_r, 2)
                R.advance()
            if ta == t:
                if h_a >> n_shift != 2:
                    vadd(r, S, h_a, 2)
                A.advance()
            if jac() > best[0]:
                best = (jac(), t + 1)
            t += 1
        out[0].append(best[0])
        out[1].append(best[1])
        out[2].append(not (S["ovf"] or init_cnt > INIT_PAD
                           or n_steps > T_PAD))
    return (np.asarray(out[0], np.int32), np.asarray(out[1], np.int32),
            np.asarray(out[2], bool))


@needs_native
@pytest.mark.parametrize("T_PAD,W,SQ", [(512, 512, 160), (4096, 512, 160),
                                        (4096, 64, 48), (512, 64, 16),
                                        (4096, 64, 16)])
def test_roll_kernel_model_matches_plain(T_PAD, W, SQ):
    """The kernel's design (its register row, its reduce search, its
    carried shifts, its boundary reads, its prefetched cursor windows and
    its change-to-change roll) as a NumPy model against the plain version
    on the edge rows, at the card's capacities and at a store of 64
    entries that overflows; the cursors cross window edges, empty query
    windows read the boundary after the update, and most steps are
    skipped."""
    qh, rh, cols = _edge_batch(W=W, SQ=SQ)
    args = _batch_args(qh, rh, cols)
    want = re_._roll_batch_torch(*args, W=W, SQ=SQ, INIT_PAD=192,
                                 T_PAD=T_PAD, n_shift=24)
    stats = {}
    got = roll_kernel_model(rh.keys, rh.locs, len(rh.keys), lut(12),
                            qh.keys, cols, W, SQ, 192, T_PAD, 24, stats)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_.numpy())
    assert stats["refills"] > 0 and stats["late_boundary"] > 0
    assert stats["skipped"] > np.minimum(cols[5], T_PAD).sum() // 2
    if W == 64 and SQ == 48:
        assert not want[2].numpy().all()


def _mixed_steps(cols):
    """The edge rows and the first row again at n_steps on either side of
    each class's edge, 1 and 4,097 included."""
    extra = [1, 511, 512, 513, 2000, 4095, 4096, 4097]
    return tuple(np.concatenate([c, np.full(len(extra), c[0], np.int32)])
                 for c in cols[:5]) + (
        np.concatenate([cols[5], np.asarray(extra, np.int32)]),
        np.concatenate([cols[6], np.full(len(extra), cols[6][0],
                                         np.int32)]))


def test_t_classes_match_the_reference():
    n = np.r_[0:20, 500:530, 4080:4110, 10**6]
    got = re_._t_classes(n)
    assert got.dtype == np.int32
    assert got.tolist() == [ref_re._t_class(int(x)) for x in n]


@needs_native
def test_roll_engine_merged_call_equals_per_class_and_reference(
        monkeypatch):
    """The card's call (``RollEngine._run_merged``: one launch over both T
    classes at T_PAD 4,096, longest first, one upload, one pull), run on
    the CPU over the plain version, gives per interval what the per-class
    batches of ``run`` on the CPU give, and what ``sedef_tpu``'s
    ``RollEngine.run`` gives on the same plan; intervals past the ladder
    stay (0, 0, False)."""
    qh, rh, cols = _edge_batch()
    cols = _mixed_steps(cols)
    k = 12
    qk, _ = qh.device_arrays("cpu")
    rk, rl = rh.device_arrays("cpu")
    eng = re_.RollEngine(k, lut(k), batch=4)
    calls = []
    real = re_._roll_batch

    def spy(*a, **kw):
        calls.append((a[10].clone(), kw["T_PAD"]))
        return real(*a, **kw)

    monkeypatch.setattr(re_, "_roll_batch", spy)
    merged = eng._run_merged(qk, rk, rl, len(rh.keys), np.stack(cols))
    assert len(calls) == 1 and calls[0][1] == re_.T_PAD_LADDER[-1]
    steps = calls[0][0].numpy()
    assert (np.diff(steps) <= 0).all()
    classes = re_._t_classes(cols[5])
    assert len(steps) == int((classes > 0).sum())
    assert {512, 4096, 0} <= set(classes.tolist())
    calls.clear()
    per_class = eng.run(qk, rk, rl, len(rh.keys), len(rh.seq), *cols)
    assert sorted(T for _, T in calls) == [
        T for T in re_.T_PAD_LADDER
        for _ in range(-(-int((classes == T).sum()) // 4))]
    want = ref_re.RollEngine(k, lut(k), batch=4).run(
        qh.keys.astype(np.int32), rh.keys.astype(np.int32),
        rh.locs.astype(np.int32), len(rh.keys), len(rh.seq), *cols)
    for m, p, w_ in zip(merged, per_class, want):
        assert m.dtype == p.dtype == w_.dtype
        np.testing.assert_array_equal(m, p)
        np.testing.assert_array_equal(m, w_)
    past = classes == 0
    assert not merged[2][past].any() and not merged[0][past].any()
    assert merged[2].any()
