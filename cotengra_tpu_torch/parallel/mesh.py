"""Multi-GPU slice sums on ``torch.distributed`` (counterpart of
``cotengra_tpu/parallel/mesh.py``, the stand-in for the reference
cotengra's MPI and dask sliced executors).

The flat slice-id space is the data-parallel axis. JAX's ``shard_map``
over a mesh of N local devices becomes N processes here, one per card,
each one rank of a ``torch.distributed`` process group: the layout that
``torchrun --nproc_per_node=N`` (or ``torch.multiprocessing`` with the
``spawn`` start method) starts, and the one of the reference cotengra's
MPI examples. Inputs are replicated: every rank holds all of them on its
own device.

- *inner* (summed) slices are strided over the ranks (rank ``r`` takes
  slice ids ``r, r + size, ...`` of each chunk), summed on the rank
  slice by slice as ``make_full_contractor`` sums them, and combined
  with ``all_reduce(SUM)``;
- an exponent-stripped sum first takes ``all_reduce(MAX)`` of the
  exponents, rescales, then sums. A rank with no slice in a chunk adds
  mantissa 0 at exponent -inf, so it never moves the maximum. (The
  reference's padded slots add ``(0, 0)``: that lifts the maximum to at
  least 0, and ``m * 10**(e - e_max)`` then flushes any stripped value
  below ~1e-38 to zero in float32 whenever the device count does not
  divide the slice count.)
- *output-sliced* chunks can instead be block-distributed over the ranks
  (``_make_chunk_sharded``): each rank sums its chunks' inner slices
  itself. The whole output is assembled by one ``all_reduce(SUM)`` of a
  zero-filled stack that each rank fills with its own rows: gloo takes
  only ``all_reduce`` and ``broadcast`` on CUDA tensors, so one code
  path serves both backends.

A process without a process group is a mesh of size 1. NCCL takes one
rank per card; several ranks on one card run on gloo.
"""

import datetime
import functools
import io
import math
import os

import torch
import torch.distributed as dist

from .._device import resolve_device, resolve_plane_dtype
from ..convert import to_tensors
from ..ops.executor import (
    _build_best_core,
    _chunk_structure,
    _reassemble,
    _stack_chunks,
    _sum_slices,
    _user_result,
)
from ..ops.grouped import _to_planes
from ..ops.lowering import extract_contractions
from ..ops.slices import slice_arrays

# the device that ``maybe_init_distributed`` gave this process's rank
_rank_device = None


class Mesh:
    """This process's place on a one-axis device mesh: the process
    ``group`` (None for a lone process), its ``rank`` and ``size``, the
    rank's ``device`` and the axis name."""

    def __init__(self, group, rank, size, device, axis_name="slices"):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.axis_name = axis_name

    def __repr__(self):
        return (
            f"Mesh(rank={self.rank}, size={self.size}, "
            f"device={self.device}, axis_name={self.axis_name!r})"
        )


def _initialized():
    return dist.is_available() and dist.is_initialized()


def _local_rank(rank):
    return int(os.environ.get("LOCAL_RANK", rank))


def _default_device(rank):
    """``cuda:{LOCAL_RANK % device_count}``, the device a launcher's rank
    takes (raises without a card)."""
    if not torch.cuda.is_available():
        return resolve_device("cuda")
    local = _local_rank(rank) % torch.cuda.device_count()
    return resolve_device(f"cuda:{local}")


def get_default_mesh(n_devices=None, axis_name="slices", devices=None):
    """The mesh of every rank of the default process group, or a mesh
    of size 1 without one.

    JAX's mesh of N local devices in one process is N processes here,
    one per device: start them with ``torchrun --nproc_per_node=N`` (or
    spawn them) and call ``maybe_init_distributed`` in each. A mesh spans
    the whole group: ``n_devices`` other than its size raises.

    ``devices`` is this rank's device, or a sequence of devices of which
    the rank takes ``devices[LOCAL_RANK % len(devices)]``. By default it
    is the device ``maybe_init_distributed`` chose, else
    ``cuda:{LOCAL_RANK % device_count}``.
    """
    if _initialized():
        group = dist.group.WORLD
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices}, but this process group has {size} "
            "rank(s): start one process per device (torchrun "
            f"--nproc_per_node={n_devices}) and call "
            "maybe_init_distributed in each"
        )
    if devices is None:
        device = _rank_device if _rank_device is not None else (
            _default_device(rank)
        )
    else:
        if isinstance(devices, (list, tuple)):
            devices = devices[_local_rank(rank) % len(devices)]
        device = resolve_device(devices)
    return Mesh(group, rank, size, device, axis_name)


def _env_int(name):
    try:
        return int(os.environ[name])
    except KeyError:
        raise ValueError(
            f"{name} is not set: pass it to maybe_init_distributed or "
            "start the processes with a launcher (torchrun) that sets it"
        ) from None


def maybe_init_distributed(
    init_method=None, world_size=None, rank=None, local_rank=None,
    backend=None, device=None, timeout=None,
):
    """Join the default ``torch.distributed`` process group when one is
    configured, else do nothing. Returns whether more than one process
    is active.

    The configuration is the explicit arguments, or the launcher's
    environment: ``MASTER_ADDR`` and ``MASTER_PORT`` (``init_method``
    ``"env://"``), ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``. Without an
    ``init_method`` or ``MASTER_ADDR`` / ``MASTER_PORT`` it is a no-op.

    ``device`` is the rank's device: ``"cuda"`` (the default) takes
    ``cuda:{local_rank % device_count}`` and raises without a card;
    ``"cpu"`` and explicit ``"cuda:i"`` are taken as they are.
    ``backend`` defaults to ``"nccl"`` on CUDA and ``"gloo"`` on the
    CPU; NCCL refuses two ranks on one card, so use gloo there (gloo
    reduces and broadcasts CUDA tensors). ``timeout`` (seconds) bounds
    every collective, torch's default where unset. A failed
    initialisation raises; there is no fallback to another backend or to
    the CPU. Safe to call again.
    """
    global _rank_device

    if _initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if init_method is None and env.get("MASTER_ADDR") and env.get(
        "MASTER_PORT"
    ):
        init_method = "env://"
    if init_method is None:
        if world_size is not None or rank is not None:
            raise ValueError(
                "world_size / rank given without an init_method or "
                "MASTER_ADDR / MASTER_PORT"
            )
        return False
    world_size = int(world_size if world_size is not None
                     else _env_int("WORLD_SIZE"))
    rank = int(rank if rank is not None else _env_int("RANK"))
    if local_rank is None:
        local_rank = _local_rank(rank)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and (
        torch.cuda.is_available()
    ):
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size,
        rank=rank, **kwargs,
    )
    _rank_device = dev
    return world_size > 1


def _collective_device():
    """Where a collective's tensors live: the rank's card under NCCL,
    the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_tree(tree, root=0):
    """Make every process use process ``root``'s contraction tree.

    Every rank must contract the same tree: stochastic planning (hyper
    search, the slice finder) can pick different trees or sliced indices
    on different processes, and the sums would then mix slices of
    different trees. Rank ``root`` sends its tree as ``save_tree``'s
    JSON bytes (``torch.distributed.broadcast``); the others load them
    with the hash check on. No-op (returns ``tree``) in a single
    process.
    """
    if not _initialized() or dist.get_world_size() <= 1:
        return tree
    from ..utils.io import load_tree, save_tree

    dev = _collective_device()
    is_root = dist.get_rank() == root
    if is_root:
        buf = io.StringIO()
        save_tree(buf, tree)
        payload = torch.frombuffer(
            bytearray(buf.getvalue().encode("utf-8")), dtype=torch.uint8
        ).to(dev)
        n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    else:
        n = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(n, src=root)
    if not is_root:
        payload = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    dist.broadcast(payload, src=root)
    if is_root:
        return tree
    data = bytes(payload.cpu().numpy()).decode("utf-8")
    return load_tree(
        io.StringIO(data), tree.inputs, tree.output, tree.size_dict,
        check_hash=True,
    )


def get_global_mesh(axis_name="slices"):
    """The mesh over every rank of every process (joining the process
    group first where the environment configures one, see
    :func:`maybe_init_distributed`); a mesh of size 1 in a lone
    process."""
    maybe_init_distributed()
    return get_default_mesh(axis_name=axis_name)


def _all_reduce(t, op, mesh):
    """``t`` reduced over ``mesh`` (a new tensor; complex tensors as
    their real view, since ``MAX`` takes no complex)."""
    if mesh.group is None:
        return t
    buf = (torch.view_as_real(t) if t.is_complex() else t).clone()
    dist.all_reduce(buf, op=op, group=mesh.group)
    return torch.view_as_complex(buf) if t.is_complex() else buf


def _combine_stripped(parts, zero, mesh):
    """(mantissa, exponent) partial sums per chunk, None where this rank
    had no slice, summed over ``mesh``: exponents to their maximum
    first, a missing part as mantissa 0 at exponent -inf."""
    neg_inf = torch.full((), -math.inf, dtype=zero.real.dtype,
                         device=zero.device)
    ms = torch.stack([zero if p is None else p[0] for p in parts])
    es = torch.stack([neg_inf if p is None else p[1] for p in parts])
    e_max = _all_reduce(es, dist.ReduceOp.MAX, mesh)
    # every rank without a slice (-inf - -inf): a zero at exponent 0
    e_max = torch.where(torch.isneginf(e_max), torch.zeros_like(e_max),
                        e_max)
    scale = torch.where(
        torch.isneginf(es), torch.zeros_like(es), 10.0 ** (es - e_max)
    )
    ms = ms * scale.reshape(scale.shape + (1,) * (ms.dim() - 1))
    ms = _all_reduce(ms, dist.ReduceOp.SUM, mesh)
    return list(zip(ms.unbind(), e_max.unbind()))


def make_sharded_contractor(
    tree,
    mesh,
    axis_name="slices",
    strip_exponent=False,
    shard_chunks="auto",
    reassemble=True,
    implementation=None,
    plane_dtype=torch.float32,
):
    """The full sliced contraction of ``tree`` with its slice sum sharded
    over ``mesh``: ``fn(*tensors)`` on the raw (unsliced) inputs, on
    ``mesh.device``, called by every rank of the mesh. Returns the
    result on every rank, or ``(mantissa, exponent)`` with
    ``strip_exponent``. ``implementation`` and ``plane_dtype`` are
    ``make_full_contractor``'s.

    Two distribution regimes over the flat slice-id space:

    - **inner-sharded** (when there are fewer output chunks than ranks,
      e.g. amplitudes and scalars): rank ``r`` sums slice ids ``r, r +
      size, ...`` of each chunk, and the partial sums are combined with
      ``all_reduce``. An unsliced tree is contracted whole on every
      rank.
    - **chunk-sharded** (``shard_chunks=True``, or ``"auto"`` with at
      least one chunk per rank): output chunks are block-distributed,
      ``ceil(n_chunks / size)`` per rank, each summed over its inner
      slices on its rank. ``reassemble=False`` returns the rank's own
      ``(n_per, *chunk_shape)`` stack (rows past the last chunk zero;
      the counterpart of the JAX package's shard of the chunk axis), and
      a per-chunk exponent vector when stripped; by default every rank
      gets the whole output.
    """
    if axis_name != mesh.axis_name:
        raise ValueError(
            f"mesh axis is {mesh.axis_name!r}, not {axis_name!r}"
        )
    dev = mesh.device
    pdt = resolve_plane_dtype(plane_dtype)
    ir = extract_contractions(tree)
    core, plane_io = _build_best_core(
        tree, ir, dev, strip_exponent, implementation, pdt
    )
    n_inner, n_chunks, _ = _chunk_structure(tree)
    chunk_shape = tuple(tree.size_dict[ix] for ix in ir.output_legs)
    offset = 1 if plane_io else 0

    def prepare(arrays):
        """The core's inputs, the map from a core result to the user's,
        and the user result's zero."""
        any_complex = any(a.is_complex() for a in arrays)
        if plane_io:
            dtype = pdt.to_complex() if any_complex else pdt
            inputs = [_to_planes(a, pdt) for a in arrays]

            def finish(res):
                return _user_result(res, any_complex)
        else:
            dtype = functools.reduce(
                torch.promote_types, (a.dtype for a in arrays)
            )
            inputs = arrays

            def finish(res):
                return res
        return inputs, finish, torch.zeros(chunk_shape, dtype=dtype,
                                           device=dev)

    def local_sum(inputs, finish, ids):
        """This rank's sum over slice ``ids`` (None without any)."""
        acc = _sum_slices(
            lambda sid: core(*slice_arrays(tree, inputs, sid, offset)), ids
        )
        return None if acc is None else finish(acc)

    if shard_chunks == "auto":
        shard_chunks = n_chunks >= mesh.size
    if shard_chunks and n_chunks > 1 and tree.sliced_inds:
        return _make_chunk_sharded(
            tree, mesh, ir, prepare, local_sum, n_inner, n_chunks,
            strip_exponent, reassemble,
        )

    def fn(*arrays):
        inputs, finish, zero = prepare(arrays)
        if not tree.sliced_inds:
            return finish(core(*inputs))
        parts = [
            local_sum(
                inputs, finish,
                range(c * n_inner + mesh.rank, (c + 1) * n_inner, mesh.size),
            )
            for c in range(n_chunks)
        ]
        if strip_exponent:
            results = _combine_stripped(parts, zero, mesh)
        else:
            results = _all_reduce(
                torch.stack([zero if p is None else p for p in parts]),
                dist.ReduceOp.SUM, mesh,
            ).unbind()
        if n_chunks == 1:
            return results[0]
        return _stack_chunks(tree, list(results), ir.output_legs)

    return fn


def _make_chunk_sharded(
    tree, mesh, ir, prepare, local_sum, n_inner, n_chunks, strip_exponent,
    reassemble,
):
    """Chunk-sharded regime: rank ``r`` owns chunks ``r * n_per ...
    (r + 1) * n_per - 1`` and sums each one's inner slices itself."""
    n_per = -(-n_chunks // mesh.size)
    own = range(mesh.rank * n_per, (mesh.rank + 1) * n_per)

    def fn(*arrays):
        inputs, finish, zero = prepare(arrays)
        parts = [
            local_sum(inputs, finish, range(c * n_inner, (c + 1) * n_inner))
            if c < n_chunks else None
            for c in own
        ]
        # rows past the last chunk: zero, at exponent 0 as the reference's
        e0 = torch.zeros((), dtype=zero.real.dtype, device=zero.device)
        if strip_exponent:
            ms = torch.stack([zero if p is None else p[0] for p in parts])
            es = torch.stack([e0 if p is None else p[1] for p in parts])
        else:
            ms = torch.stack([zero if p is None else p for p in parts])
        if not reassemble:
            return (ms, es) if strip_exponent else ms

        def gather(rows):
            full = rows.new_zeros((mesh.size * n_per,) + rows.shape[1:])
            full[own.start:own.stop] = rows
            return _all_reduce(full, dist.ReduceOp.SUM, mesh)[:n_chunks]

        if strip_exponent:
            results = list(zip(gather(ms).unbind(), gather(es).unbind()))
            return _stack_chunks(tree, results, ir.output_legs)
        return _reassemble(tree, gather(ms), ir.output_legs)

    return fn


def contract_sharded(tree, arrays, mesh=None, axis_name="slices", **kwargs):
    """Contract a sliced tree with its slice sum sharded over ``mesh``
    (by default ``get_default_mesh``), on every rank of it. ``arrays``
    are numpy arrays or tensors, replicated on every rank; real ones run
    as ``plane_dtype``. The contractor is cached on the tree, per group,
    rank, size, device and options."""
    if mesh is None:
        mesh = get_default_mesh(axis_name=axis_name)
    key = (
        "torch", "sharded", mesh.group, mesh.rank, mesh.size, mesh.device,
        axis_name, tuple(sorted(kwargs.items(), key=lambda kv: kv[0])),
    )
    try:
        fn = tree.contraction_cores[key]
    except KeyError:
        fn = tree.contraction_cores[key] = make_sharded_contractor(
            tree, mesh, axis_name=axis_name, **kwargs
        )
    plane_dtype = kwargs.get("plane_dtype", torch.float32)
    return fn(*to_tensors(arrays, mesh.device, plane_dtype))
