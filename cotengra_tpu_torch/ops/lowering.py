"""Lowering: ContractionTree -> flat einsum-IR (host only).

The same IR as ``cotengra_tpu/ops/lowering.py``, step for step: a tuple
of single-term steps (diagonal / trace / sum / transpose of a leaf) and
pairwise contractions, plus liveness. Carried here because importing
``cotengra_tpu.ops`` pulls in the reference's accelerator runtime,
which the port never needs.
"""

from collections import namedtuple

# single-term op: fold repeats (diag), sum reduced indices, of input `inp`
SingleStep = namedtuple("SingleStep", ("out", "inp", "in_legs", "out_legs"))

# pairwise contraction: out = contract(l, r)
PairStep = namedtuple(
    "PairStep", ("out", "l", "r", "l_legs", "r_legs", "out_legs")
)

ContractionIR = namedtuple(
    "ContractionIR",
    (
        "steps",  # tuple of SingleStep/PairStep
        "num_inputs",  # number of input slots
        "output_legs",  # legs of the final result, in output order
        "final_id",  # ssa id holding the final result
        "last_use",  # dict ssa id -> step index after which it can be freed
    ),
)


def sliced_input_legs(tree, i):
    """Index labels of input ``i`` with sliced indices removed but repeats
    kept (the layout of the array handed to the executor after slicing).
    """
    return tuple(
        ix for ix in tree.inputs[i] if ix not in tree.sliced_inds
    )


def extract_contractions(tree, order=None):
    """Lower ``tree`` to a :class:`ContractionIR`.

    ``order`` is the traversal order (see ``ContractionTree.traverse``).
    """
    n = tree.N
    steps = []

    # ssa ids: inputs 0..n-1; intermediates from n
    next_id = n
    node_id = {}

    # leaf preprocessing: each leaf may need diag/trace/sum folding if its
    # raw (sliced) term differs from its effective legs
    for i in range(n):
        leaf = 1 << i
        raw = sliced_input_legs(tree, i)
        legs = tree.get_legs(leaf)  # dict ix -> count
        eff = tuple(ix for ix in dict.fromkeys(raw) if ix in legs)
        if raw == eff:
            node_id[leaf] = i
        else:
            steps.append(SingleStep(next_id, i, raw, eff))
            node_id[leaf] = next_id
            next_id += 1

    if n == 1:
        # single input: possibly a pure transpose/diag/sum to output order
        out_legs = tuple(
            ix for ix in tree.output if ix not in tree.sliced_inds
        )
        cur = node_id[1]
        raw = (
            sliced_input_legs(tree, 0)
            if cur == 0
            else steps[-1].out_legs
        )
        if raw != out_legs:
            steps.append(SingleStep(next_id, cur, raw, out_legs))
            cur = next_id
            next_id += 1
        return _finish(steps, n, out_legs, cur)

    legs_order = {}  # node -> tuple of legs in computed order
    for i in range(n):
        leaf = 1 << i
        raw = sliced_input_legs(tree, i)
        legs = tree.get_legs(leaf)
        legs_order[leaf] = tuple(
            ix for ix in dict.fromkeys(raw) if ix in legs
        )

    out_legs_final = tuple(
        ix for ix in tree.output if ix not in tree.sliced_inds
    )

    for p, l, r in tree.traverse(order=order):
        l_legs = legs_order[l]
        r_legs = legs_order[r]
        p_legs_set = tree.get_legs(p)
        if p == tree.root:
            p_legs = out_legs_final
        else:
            # keep l-then-r appearance order for the parent legs
            p_legs = tuple(
                ix
                for ix in dict.fromkeys(l_legs + r_legs)
                if ix in p_legs_set
            )
        legs_order[p] = p_legs
        steps.append(
            PairStep(next_id, node_id[l], node_id[r], l_legs, r_legs, p_legs)
        )
        node_id[p] = next_id
        next_id += 1

    return _finish(steps, n, out_legs_final, node_id[tree.root])


def _finish(steps, num_inputs, output_legs, final_id):
    # liveness: record after which step each id is last used
    last_use = {}
    for si, step in enumerate(steps):
        if isinstance(step, SingleStep):
            last_use[step.inp] = si
        else:
            last_use[step.l] = si
            last_use[step.r] = si
    last_use.pop(final_id, None)
    return ContractionIR(
        tuple(steps), num_inputs, output_legs, final_id, last_use
    )
