"""Ways of calling the program, one module per ``"kind"`` that a traffic
file's ``"entry"`` names. Each has ``prepare(ctx) -> session`` (see
``harness.Context``); a session has ``call(k)`` (the entry, up to the
point where it returns), ``value(result)`` (the pull to the host, which
waits for the card: ``(mantissa, log10 exponent)``), ``describe(k)``
(the slice ids and input set of call ``k``, for the reference),
``counters()``, ``mode`` and ``release()``.
"""

import torch

def options(ctx):
    """The program's keyword options: the configuration's, then the
    traffic entry's; dtype options named as strings ("float32")."""
    opts = dict(ctx.config.get("options", {}))
    opts.update(ctx.traffic["entry"].get("options", {}))
    if isinstance(opts.get("plane_dtype"), str):
        opts["plane_dtype"] = getattr(torch, opts["plane_dtype"])
    return opts


def start_id(ctx, per_call):
    """The first slice id of the window's run, drawn from the seed in
    the lower half of the ids, so that consecutive ids never wrap."""
    n = ctx.tree.multiplicity
    return ctx.rng.randrange(max(1, n // 2 - per_call))


def pull(res):
    """The host value of a result: ``(mantissa, log10 exponent)``.

    A ``(mantissa, exponent)`` pair is a stripped result; a ``(2,)``
    float tensor is a split-complex result's planes; a 0-d tensor is a
    plain value. The first ``.item()`` waits for the card."""
    if isinstance(res, tuple):
        m, e = res
        return _scalar(m), float(e.item())
    return _scalar(res), 0.0


def _scalar(t):
    if t.dim() == 1 and t.shape[0] == 2 and not t.is_complex():
        p = t.to("cpu", torch.float64)
        return complex(p[0].item(), p[1].item())
    v = t.item()
    return complex(v) if isinstance(v, complex) else float(v)


def sum_batch(res):
    """Sum a batched result over its leading (slice) axis on the card; a
    stripped batch ``(mantissas, log10 exponents)`` at its largest
    exponent."""
    if isinstance(res, tuple):
        ms, es = res
        e = es.amax()
        scale = (10.0 ** (es - e)).reshape(es.shape + (1,) * (ms.dim() - 1))
        return (ms * scale.to(ms.dtype)).sum(0), e
    return res.sum(0)
