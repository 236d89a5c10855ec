"""Step tables with out-of-range indices, made with numpy, shared by the
CPU tests against the JAX package (tests/test_torch_gathers.py) and the
tests on the card (tests/test_torch_serving_cuda.py).

A step row is ``(ty, pu1, pu2, label, new, idx, valid, key)``; the
fields that index something are the step key (into ``K`` token-index
buckets), the itemset slot ``idx`` (into ``ni`` phi columns) and the
pattern vertices ``pu1`` / ``pu2`` (into ``nv`` psi columns)."""
import numpy as np

# step-row column of each field that indexes, and the axis it indexes
FIELDS = {"key": 7, "idx": 5, "pu1": 1, "pu2": 2}


def out_of_range(n):
    """The out-of-range indices into an axis of ``n``: one that wraps
    into range, one below it, the first past it and one further on."""
    return (-1, -(n + 3), n, n + 7)


def out_of_range_steps(steps, *, K, ni, nv, fields=tuple(FIELDS),
                       every=1):
    """A copy of ``steps`` [..., 8] whose every ``every``-th real row
    (``valid > 0``, in C order) has one of ``fields`` set out of range,
    the fields and values taken in turn, so that every (field, value)
    pair occurs.  Returns ``(steps, n_changed)``."""
    sizes = {"key": K, "idx": ni, "pu1": nv, "pu2": nv}
    out = np.array(steps, np.int32, copy=True)
    flat = out.reshape(-1, 8)
    real = np.nonzero(flat[:, 6] > 0)[0][::every]
    pairs = [(f, v) for f in fields for v in out_of_range(sizes[f])]
    for q, row in enumerate(real):
        field, value = pairs[q % len(pairs)]
        flat[row, FIELDS[field]] = value
    return out, len(real)
