"""Host-side network preprocessing: absorb trivial tensors before
planning (the same procedure as ``cotengra_tpu/ops/preprocess.py``,
carried here so that the port never imports ``cotengra_tpu.ops``).

Rank-1 and rank-2 tensors (state vectors, single-qubit gates,
projectors) are contracted into a neighbouring tensor with numpy. This
shrinks the network without changing the result.
"""

import numpy as np

from cotengra_tpu.utils.symbols import get_symbol


def absorb_simple_tensors(
    inputs, arrays, output=(), max_rank=2, max_absorb_size=None
):
    """Contract every tensor of rank <= ``max_rank`` into a neighbouring
    tensor (numpy einsum), repeatedly, unless doing so would grow the
    neighbour beyond ``max_absorb_size`` elements.

    Returns ``(new_inputs, new_arrays)``. A tensor is only absorbed along
    non-output sharing.
    """
    inputs = [tuple(t) for t in inputs]
    arrays = [np.asarray(a) for a in arrays]
    out_set = set(output)

    def build_holders():
        holders = {}
        for p, term in enumerate(inputs):
            if term is None:
                continue
            for ix in term:
                holders.setdefault(ix, []).append(p)
        return holders

    changed = True
    while changed:
        changed = False
        holders = build_holders()
        for p, term in enumerate(inputs):
            if term is None or len(term) > max_rank:
                continue
            cands = []
            for ix in term:
                for q in holders.get(ix, ()):
                    if q != p and inputs[q] is not None:
                        cands.append(q)
            if not cands:
                continue
            # absorb into the smallest neighbour
            q = min(cands, key=lambda q: arrays[q].size)
            ta, tb = term, inputs[q]
            shared = set(ta) & set(tb)
            keep = [
                ix
                for ix in dict.fromkeys(ta + tb)
                if ix in out_set
                or ix not in shared
                or len(holders.get(ix, ())) > 2
            ]
            if max_absorb_size is not None:
                new_size = 1
                sizes = {}
                for t, arr in ((ta, arrays[p]), (tb, arrays[q])):
                    for ix, d in zip(t, arr.shape):
                        sizes[ix] = d
                for ix in keep:
                    new_size *= sizes[ix]
                if new_size > max_absorb_size:
                    continue

            symmap = {}
            for ix in dict.fromkeys(ta + tb):
                symmap[ix] = get_symbol(len(symmap))
            eq = (
                "".join(symmap[ix] for ix in ta)
                + ","
                + "".join(symmap[ix] for ix in tb)
                + "->"
                + "".join(symmap[ix] for ix in keep)
            )
            arrays[q] = np.einsum(eq, arrays[p], arrays[q])
            inputs[q] = tuple(keep)
            inputs[p] = None
            arrays[p] = None
            changed = True
            holders = build_holders()

    new_inputs = [t for t in inputs if t is not None]
    new_arrays = [a for a in arrays if a is not None]
    if not new_inputs:
        # everything absorbed: recover a scalar
        return [()], [np.asarray(1.0)]
    return new_inputs, new_arrays
