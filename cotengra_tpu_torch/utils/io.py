"""Load saved contraction trees (counterpart of
``cotengra_tpu/utils/io.py``: ``load_tree`` and the permutation-invariant
content hash ``hash_contraction_b``, byte for byte, so that the plans
saved by the JAX package load here with their check on)."""

import hashlib
import json
import pickle


def load_tree(filename, inputs, output, size_dict, check_hash=True):
    """Rebuild a saved contraction tree against the given instance.

    Raises ``ValueError`` if the instance's content hash doesn't match
    the one stored (``check_hash=False`` skips this).
    """
    from ..tree import ContractionTree

    if hasattr(filename, "read"):
        data = json.load(filename)
    else:
        with open(filename) as f:
            data = json.load(f)
    if check_hash:
        h = hash_contraction_b(inputs, output, size_dict)
        if h != data["hash_b"]:
            raise ValueError(
                "Saved tree was built for a different instance "
                f"(hash {data['hash_b'][:12]} != {h[:12]})."
            )
    tree = ContractionTree(
        inputs, output, size_dict,
        children={
            int(p): (int(lr[0]), int(lr[1]))
            for p, lr in data["children"].items()
        },
    )
    for ix in data["sliced_inds"]:
        tree.remove_ind_(ix)
    return tree


def hash_contraction_b(inputs, output, size_dict):
    """Permutation-invariant content hash: invariant to both input order
    and index relabelling, via Weisfeiler-Lehman-style refinement of the
    term/index incidence structure.
    """
    out_set = set(output)
    # initial labels
    ix_label = {
        ix: (size_dict[ix], ix in out_set)
        for term in inputs
        for ix in term
    }
    term_labels = [
        tuple(sorted(ix_label[ix] for ix in term)) for term in inputs
    ]

    for _ in range(2):
        # refine index labels from the terms containing them
        ix_terms = {}
        for tl, term in zip(term_labels, inputs):
            for ix in term:
                ix_terms.setdefault(ix, []).append(tl)
        ix_label = {
            ix: (
                size_dict[ix],
                ix in out_set,
                tuple(sorted(map(repr, tls))),
            )
            for ix, tls in ix_terms.items()
        }
        term_labels = [
            tuple(sorted(map(repr, (ix_label[ix] for ix in term))))
            for term in inputs
        ]

    payload = pickle.dumps(
        (
            sorted(map(repr, term_labels)),
            sorted(repr(ix_label[ix]) for ix in output),
        ),
        protocol=4,
    )
    return hashlib.sha1(payload).hexdigest()
