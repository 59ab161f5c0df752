"""The number of distinct labels in an array, in one linear pass where the
labels allow it.

A solve's ``fragment`` holds one label a vertex, and the forest's component
count is the number of distinct labels. On every backend those labels are
vertex ids, so they are non-negative and below the padded vertex count: a
presence mask of ``max + 1`` bytes, set at each label and counted, gives the
count exactly with no sort. :func:`count_labels` takes that pass when the
input shows it is cheap (integer labels, the least at least 0, the greatest
below :data:`MASK_SPAN` times their number) and ``np.unique`` otherwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: The widest mask the linear pass builds, as a multiple of the label count:
#: ``max + 1`` may be at most this many bytes a label.
MASK_SPAN = 4


def count_labels_with_method(labels) -> Tuple[int, str]:
    """``(distinct labels, method)``: ``method`` is ``"mask"`` for the
    presence mask (also for no labels) and ``"unique"`` for the sort."""
    labels = np.asarray(labels).reshape(-1)
    if labels.size == 0:
        return 0, "mask"
    if np.issubdtype(labels.dtype, np.integer):
        lo, hi = int(labels.min()), int(labels.max())
        if lo >= 0 and hi < MASK_SPAN * labels.size:
            seen = np.zeros(hi + 1, dtype=bool)
            seen[labels] = True
            return int(np.count_nonzero(seen)), "mask"
    return int(np.unique(labels).size), "unique"


def count_labels(labels) -> int:
    """The number of distinct values in ``labels``, exactly
    (:func:`count_labels_with_method` without the method)."""
    return count_labels_with_method(labels)[0]
