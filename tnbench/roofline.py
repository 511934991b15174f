"""Least times of the program's hand-written kernels, from the shapes
recorded at their wrappers, against published peaks of the card.

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense (no sparsity), at the
card's full 700 W power limit (the result line gives the limit the card
ran at): HBM3 3.35 TB/s; TF32 tensor cores 494.7 TFLOP/s. Every byte
that a launch must read is counted once and every byte it writes once,
whatever the kernel reads again; the operations are those of the
product the launch computes.

The operation bound of both kernels is taken at the TF32 rate: any
float32-accurate product on the tensor cores passes through it at
least once (the 3xTF32 route of ``bmm_absmax`` three times), so an
implementation that computes the same work another way cannot read
above 100% of it. Against the 67 TFLOP/s float32 rate outside the
tensor cores, ``bmm_absmax`` would read above 100%.
"""

import math

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 494.7e12
FLOAT_BYTES = 4


def chain_bound_s(x_shape, out_shape, gate_shapes):
    """Least seconds of one gate-chain call (every pass of one chain,
    for one slice or a batch): the float32 planes of x read once, of the
    result written once, each gate's planes read once, at the HBM rate;
    or the chain's complex multiply-adds, 8 flops each, at the TF32
    rate, the larger (the arithmetic of ``chip_smoke.py``'s
    ``_chain_bound`` on recorded shapes).

    ``x_shape`` is ``(2 * n,)`` or ``(S, 2 * n)`` flat planes; each gate
    is ``(2, K, N)`` or ``(S, 2, K, N)``: a gate takes the state's K
    values along its legs to N, so the state goes from ``n`` to
    ``n / K * N`` elements and costs ``n * N`` multiply-adds."""
    nbytes = FLOAT_BYTES * (
        math.prod(x_shape) + math.prod(out_shape) + sum(math.prod(g) for g in gate_shapes)
    )
    state = math.prod(x_shape) // 2
    flops = 0
    for g in gate_shapes:
        k, n = g[-2], g[-1]
        flops += 8 * state * n
        state = state // k * n
    return max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS)


def bmm_bound_s(x_shape, y_shape):
    """Least seconds of one ``(B, M, K) @ (B, K, N)`` float32 product
    with its |max|: 2 B M N K flops at the TF32 rate, or x and y read
    once and the product written once at the HBM rate, the larger."""
    B, M, K = x_shape
    N = y_shape[2]
    flops = 2 * B * M * N * K
    nbytes = FLOAT_BYTES * B * (M * K + K * N + M * N)
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)


BOUNDS = {
    "gate_chain": lambda rec: chain_bound_s(*rec),
    "bmm_absmax": lambda rec: bmm_bound_s(*rec),
}


def roofline(profile, kernel):
    """Sum of least times over the kernel's profiled device time, over
    the profiled calls whose records arrived whole; None where they
    launched no such kernel."""
    from tnbench.trace import kernel_seconds

    bound = spent = 0.0
    for call in profile.whole():
        if not call["launches"][kernel]:
            continue
        bound += sum(BOUNDS[kernel](rec) for rec in call["shapes"][kernel])
        spent += kernel_seconds(call, kernel)
    if spent <= 0.0:
        return None
    return bound / spent
