"""JSON save/load of contraction instances and trees, and the
permutation-invariant content hash (counterpart of
``cotengra_tpu/utils/io.py``, byte for byte: a file saved by either
package loads in the other with its hash check on)."""

import hashlib
import json
import pickle


def _dump(data, filename):
    if hasattr(filename, "write"):
        json.dump(data, filename)
    else:
        with open(filename, "w") as f:
            json.dump(data, f)


def _load(filename):
    if hasattr(filename, "read"):
        return json.load(filename)
    with open(filename) as f:
        return json.load(f)


def save_instance(filename, inputs, output, size_dict, **meta):
    """Save a contraction instance as JSON."""
    _dump(
        {
            "inputs": [list(map(str, term)) for term in inputs],
            "output": list(map(str, output)),
            "size_dict": {str(k): int(v) for k, v in size_dict.items()},
            **meta,
        },
        filename,
    )


def load_instance(filename):
    """Load a contraction instance from JSON, returning
    ``(inputs, output, size_dict)`` (plus any extra metadata dict).
    """
    data = _load(filename)
    inputs = [tuple(term) for term in data.pop("inputs")]
    output = tuple(data.pop("output"))
    size_dict = data.pop("size_dict")
    if data:
        return inputs, output, size_dict, data
    return inputs, output, size_dict


def save_tree(filename, tree, **meta):
    """Save a (possibly sliced) contraction tree as JSON: the children
    map (int-bitmask nodes as decimal strings), the sliced indices, and
    a content hash of the instance for load-time validation.
    """
    _dump(
        {
            "hash_b": hash_contraction_b(
                tree.inputs, tree.output, tree.size_dict
            ),
            "children": {
                str(p): [str(l), str(r)]
                for p, (l, r) in tree.children.items()
            },
            "sliced_inds": [str(ix) for ix in tree.sliced_inds],
            **meta,
        },
        filename,
    )


def load_tree(filename, inputs, output, size_dict, check_hash=True):
    """Rebuild a saved contraction tree against the given instance.

    Raises ``ValueError`` if the instance's content hash doesn't match
    the one stored (``check_hash=False`` skips this).
    """
    from ..tree import ContractionTree

    data = _load(filename)
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
