"""Row gathers (port of mitsuba_tpu/core/gather.py).

The reference replaces small-table gathers with one-hot matrix products
because random gathers are slow on the TPU; both forms return the same
values.  On a GPU a gather is an indexed load, so here they are plain
indexing.
"""

from __future__ import annotations


def take_rows(table, idx):
    """table[idx] for a [T, C] or [T] table."""
    return table[idx]


def take_fused(idx, *tables):
    """[t[idx] for t in tables]: rows of several tables sharing ids."""
    return [t[idx] for t in tables]
