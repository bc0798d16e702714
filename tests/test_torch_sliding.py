"""The port's scalar sketch (``sedef_tpu_torch.ops.sliding``) against the
reference package's (``sedef_tpu.ops.sliding``): the same op streams
through both ``SlidingJaccard``s, every state equal after every op, and
equal to the reference oracle's recorded states (the fixtures of
``tests/test_sliding.py``).  The device roll engine reproduces exactly
these quirks, so this guards the model it is held to.  Tolerance: exact
equality (integer states)."""

import numpy as np
import pytest

from sedef_tpu.ops.sliding import SlidingJaccard as RefSliding
from sedef_tpu_torch.ops.sliding import SlidingJaccard

K = 12


def _key(hash_val: int, status: int) -> int:
    return (status << (2 * K)) | hash_val


def _apply(sm, op, key):
    (sm.add_to_query, sm.remove_from_query, sm.add_to_reference,
     sm.remove_from_reference)[op](key)


def _state(sm):
    return (sm.query_size, sm.intersection, int(sm.limit), sm.jaccard())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_oracle_streams_match_reference(fixtures_dir, seed):
    mine, ref = SlidingJaccard(K), RefSliding(K)
    lines = (fixtures_dir / f"sliding_ops_{seed}.txt").read_text().splitlines()
    for i in range(0, len(lines), 2):
        op_line = lines[i].split()
        assert op_line[0] == "OP"
        op, hv, st = int(op_line[1]), int(op_line[2]), int(op_line[3])
        _apply(mine, op, _key(hv, st))
        _apply(ref, op, _key(hv, st))
        step, *want = map(int, lines[i + 1].split())
        assert _state(mine) == _state(ref) == tuple(want), f"step {step}"


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_random_streams_match_reference(seed):
    """Random op streams over a small key space (so keys collide on the
    boundary), with HAS_N reference keys and removals of absent keys."""
    rng = np.random.default_rng(seed)
    mine, ref = SlidingJaccard(K), RefSliding(K)
    live_q, live_r = [], []
    for _ in range(3000):
        op = int(rng.integers(4))
        if op in (1, 3) and (live_q if op == 1 else live_r) and \
                rng.random() < 0.8:
            live = live_q if op == 1 else live_r
            key = live.pop(int(rng.integers(len(live))))
        else:
            key = _key(int(rng.integers(64)), int(rng.choice([0, 1, 2])))
            if op in (0, 2):
                (live_q if op == 0 else live_r).append(key)
        _apply(mine, op, key)
        _apply(ref, op, key)
        assert _state(mine) == _state(ref)
        assert mine.keys == ref.keys and mine.B == ref.B


def test_copy_independent_as_reference():
    mine, ref = SlidingJaccard(K), RefSliding(K)
    for sm in (mine, ref):
        for h in [5, 9, 3, 7]:
            sm.add_to_query(_key(h, 0))
    cm, cr = mine.copy(), ref.copy()
    cm.add_to_reference(_key(5, 0))
    cr.add_to_reference(_key(5, 0))
    assert _state(mine) == _state(ref) and mine.intersection == 0
    assert _state(cm) == _state(cr) and cm.intersection == 1
