"""The plain reference that decides ``correct``: NumPy alone, written from
SEDEF's semantics, importing nothing of the program (nor torch).

It judges the program's answers by what they say:

* ``dp``: a gap DP's CIGAR is an alignment of its two inputs and scores
  the optimum of SEDEF's global affine-gap recurrence (Gotoh; ksw2's
  ``extz2`` scoring), worked out again here;
* ``rows``: an alignment row (a pair's chain hit, an ``aligned.bed`` or a
  ``final.bed`` row) spans its coordinates on the generated sequences, its
  tallies and statistics are those its CIGAR gives there, and a final row
  passes the filters the configuration states;
* ``cover``: the share of the planted homology (a simulated pair's two
  copies, a genome's planted SDs) that the program's rows cover.
"""
