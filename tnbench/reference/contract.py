"""Pairwise contraction of a saved plan in plain PyTorch.

The plan is the JSON that the port's ``save_tree`` writes: ``children``
maps each node (a bit mask over the input positions, as a decimal
string) to its two children, and ``sliced_inds`` lists the indices that
are fixed per slice. A flat slice id is read in mixed radix over the
sliced indices sorted by name (output indices first), the last the
fastest: cotengra's ``ContractionTree.slice_key``.

Every node is one batched matmul (``torch.bmm``) of its children, in
the dtype asked for: complex128 or float64 for the reference, complex64
or float32 with each operand rounded to TF32 (``tf32=True``) for the
control, the precision below the float32 that the configurations state.
``strip=True`` scales every intermediate by a power of two that brings
its largest magnitude into [0.5, 1), exactly, and carries the exponent:
a float32 control of a value beyond float32's range needs it.
"""

import math

import torch

# a CUDA copy takes at most 25 dimensions after merging
_MAX_COPY_DIMS = 25


def tf32_round(t):
    """``t`` (float32 or complex64) with every float rounded to TF32's
    10-bit mantissa, to nearest with ties away from zero, as the tensor
    cores' conversion does."""
    if t.is_complex():
        return torch.view_as_complex(tf32_round(torch.view_as_real(t)))
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _perm_copy(t, perm):
    if t.dim() <= _MAX_COPY_DIMS:
        return t.permute(perm).contiguous()
    first = perm[0]
    rest = [p - (p > first) for p in perm[1:]]
    out = t.new_empty([t.shape[p] for p in perm])
    for i in range(t.shape[first]):
        out[i] = _perm_copy(t.select(first, i), rest)
    return out


def permute(t, perm):
    """``t.permute(perm).contiguous()`` for a contiguous ``t`` of any
    rank: dimensions that stay adjacent merge first, and a copy still
    wider than a CUDA copy takes runs one leading index at a time."""
    perm = list(perm)
    if perm == sorted(perm):
        return t
    groups = []
    for d in perm:
        if groups and groups[-1][-1] + 1 == d:
            groups[-1].append(d)
        else:
            groups.append([d])
    order = sorted(range(len(groups)), key=lambda g: groups[g][0])
    merged = t.reshape([math.prod(t.shape[d] for d in groups[g]) for g in order])
    out = _perm_copy(merged, [order.index(g) for g in range(len(groups))])
    return out.reshape([t.shape[d] for d in perm])


def _pair(x, lx, y, ly, keep, tf32):
    """Contract ``x`` (legs ``lx``) with ``y`` (legs ``ly``) into the
    legs of ``keep`` that they hold; returns ``(out, legs)``."""
    sx, sy = set(lx), set(ly)
    for t, legs, other in ((0, lx, sy), (1, ly, sx)):
        summed = [i for i, ix in enumerate(legs) if ix not in other and ix not in keep]
        if summed:
            if t == 0:
                x = x.sum(summed)
                lx = [ix for ix in lx if ix in other or ix in keep]
            else:
                y = y.sum(summed)
                ly = [ix for ix in ly if ix in other or ix in keep]
    sx, sy = set(lx), set(ly)
    batch = [ix for ix in lx if ix in sy and ix in keep]
    con = [ix for ix in lx if ix in sy and ix not in keep]
    xf = [ix for ix in lx if ix not in sy]
    yf = [ix for ix in ly if ix not in sx]
    size = dict(zip(lx, x.shape))
    size.update(zip(ly, y.shape))
    B = math.prod(size[ix] for ix in batch)
    M = math.prod(size[ix] for ix in xf)
    K = math.prod(size[ix] for ix in con)
    N = math.prod(size[ix] for ix in yf)
    if not batch and lx[: len(con)] == con:
        # contracted legs lead: a transposed view, no copy
        x3 = x.reshape(1, K, M).transpose(1, 2)
        con = lx[: len(con)]
    else:
        x3 = permute(x, [lx.index(ix) for ix in batch + xf + con]).reshape(B, M, K)
    y3 = permute(y, [ly.index(ix) for ix in batch + con + yf]).reshape(B, K, N)
    if tf32:
        x3, y3 = tf32_round(x3), tf32_round(y3)
    out = torch.bmm(x3, y3)
    legs = batch + xf + yf
    return out.reshape([size[ix] for ix in legs]), legs


def _slice_order(sliced_inds, output):
    out_set = set(output)
    return sorted(sliced_inds, key=lambda ix: (ix not in out_set, ix))


def slice_values(sliced_inds, output, size_dict, i):
    """``{index: value}`` of flat slice id ``i``."""
    order = _slice_order(sliced_inds, output)
    key = {}
    for ix in reversed(order):
        i, key[ix] = divmod(i, size_dict[ix])
    return key


def _post_order(children, root):
    order, stack = [], [(root, False)]
    while stack:
        node, done = stack.pop()
        if node not in children:
            continue
        if done:
            order.append(node)
        else:
            left, right = children[node]
            stack += [(node, True), (right, False), (left, False)]
    return order


class Plan:
    """A saved plan bound to its network: the node order, and each
    node's surviving legs once the sliced indices are fixed."""

    def __init__(self, plan, inputs, output, size_dict):
        self.inputs = [list(t) for t in inputs]
        self.output = list(output)
        self.size_dict = dict(size_dict)
        self.sliced = list(plan["sliced_inds"])
        self.children = {
            int(p): (int(lr[0]), int(lr[1])) for p, lr in plan["children"].items()
        }
        n = len(self.inputs)
        self.root = (1 << n) - 1
        masks = {}
        for pos, term in enumerate(self.inputs):
            for ix in term:
                masks[ix] = masks.get(ix, 0) | (1 << pos)
        drop, out_set = set(self.sliced), set(self.output)
        self.leaf_legs = [[ix for ix in t if ix not in drop] for t in self.inputs]
        self.order = _post_order(self.children, self.root)
        self.legs = {1 << p: legs for p, legs in enumerate(self.leaf_legs)}
        self.keep = {}
        for node in self.order:
            left, right = self.children[node]
            seen = dict.fromkeys(self.legs[left] + self.legs[right])
            self.keep[node] = {
                ix for ix in seen if ix in out_set or masks[ix] & ~node
            }
            self.legs[node] = [ix for ix in seen if ix in self.keep[node]]
        if len(self.order) != n - 1:
            raise ValueError(
                f"plan has {len(self.order)} contractions for {n} inputs"
            )

    def contract(self, arrays, slice_ids, dtype, device, strip=False, tf32=False):
        """``contract_slices`` of this plan: the reference's interface
        (``prepare``)."""
        return contract_slices(self, arrays, slice_ids, dtype, device, strip=strip, tf32=tf32)

    def contract_slice(self, leaves, i, strip=False, tf32=False):
        """One slice: ``(mantissa, log2 exponent)``, the mantissa a 0-d
        tensor (a tensor in the output's legs, in ``self.output``'s
        order), the exponent an int tensor on the same device."""
        key = slice_values(self.sliced, self.output, self.size_dict, i)
        temps = {}
        for pos, (arr, term) in enumerate(zip(leaves, self.inputs)):
            for ax in reversed(range(len(term))):
                if term[ax] in key:
                    arr = arr.select(ax, key[term[ax]])
            temps[1 << pos] = (arr.contiguous(), self.leaf_legs[pos])
        dev = leaves[0].device
        exponent = torch.zeros((), dtype=torch.int64, device=dev)
        for node in self.order:
            left, right = self.children[node]
            (x, lx), (y, ly) = temps.pop(left), temps.pop(right)
            out, legs = _pair(x, lx, y, ly, self.keep[node], tf32)
            if strip:
                e = torch.frexp(out.abs().amax()).exponent.to(torch.int64)
                scale = torch.pow(2.0, (-e).to(torch.float64))
                out = out * scale.to(out.real.dtype)
                exponent = exponent + e
            temps[node] = (out, legs)
        out, legs = temps.pop(self.root)
        if legs != self.output:
            out = permute(out, [legs.index(ix) for ix in self.output])
        return out, exponent


def contract_slices(plan, arrays, slice_ids, dtype, device, strip=False,
                    tf32=False):
    """Sum of the plan's slices ``slice_ids`` over the raw inputs
    ``arrays`` (numpy), contracted in ``dtype`` on ``device``.

    Returns ``(sum, norm, log2 exponent)``: the complex sum of the
    slices (scalar outputs) and the root of the sum of their squared
    magnitudes, both in float64 at the largest slice exponent (an int),
    so that ``sum * 2**exponent`` is the value."""
    leaves = [torch.from_numpy(a).to(device=device, dtype=_as(dtype, a)) for a in arrays]
    parts = []
    for i in slice_ids:
        m, e = plan.contract_slice(leaves, i, strip=strip, tf32=tf32)
        parts.append((complex(m.to(torch.complex128).item()), int(e.item())))
    emax = max(e for _, e in parts)
    total = sum(m * 2.0 ** (e - emax) for m, e in parts)
    norm = math.sqrt(sum(abs(m * 2.0 ** (e - emax)) ** 2 for m, e in parts))
    return total, norm, emax


def prepare(config, inputs, output, size_dict):
    """The exact reference of a configuration: its committed plan,
    walked slice by slice (``Plan.contract``)."""
    return Plan(config["plan"], inputs, output, size_dict)


def _as(dtype, a):
    """``dtype`` for a complex input, its real counterpart for a real
    one (a real network stays real)."""
    if a.dtype.kind == "c":
        return dtype
    return {torch.complex128: torch.float64, torch.complex64: torch.float32}.get(
        dtype, dtype
    )
