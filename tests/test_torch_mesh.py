"""The port's multi-GPU slice sums (``cotengra_tpu_torch.parallel.mesh``)
against the JAX package's ``contract_sharded``, on the CPU with gloo
ranks.

Each launch runs this file as a script (``--worker``) in one process
per rank, with ``jax``, ``jaxlib`` and ``cotengra_tpu`` blocked; the
ranks join a gloo group through a file store in the test's temporary
directory, so that parallel test workers share no port. The reference
runs on the conftest's 8 virtual devices, on a mesh of as many devices
as the launch has ranks, with the same numpy inputs and the same tree
(planned by the reference, saved with its ``save_tree`` and loaded by
each rank with the port's ``load_tree``). One launch of 4 ranks runs
every case of ``tests/test_mesh.py``, uneven slice counts, more ranks
than slices and the stripped sum of tiny values that the reference
flushes to zero; one launch of 2 ranks mirrors
``tests/test_multihost.py`` (the launcher's environment,
``get_global_mesh``, ``broadcast_tree``).
"""

import sys

if __name__ == "__main__":
    # a rank imports only the port: block the JAX package and JAX
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "cotengra_tpu"):
                raise ImportError(name + " is blocked in a mesh rank")
            return None

    sys.meta_path.insert(0, _Block())

import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4            # ranks of the main launch
LAUNCH_LIMIT_S = 120  # wall-clock limit of one launch; a hang fails it
COLLECTIVE_S = 60     # gloo timeout of every collective in a rank
TINY = 1e-6           # entries of the stripped case the reference loses


# -- the ranks ---------------------------------------------------------------


def _port_case(ctt, workdir, name):
    """(tree, arrays, options) of case ``name`` as the port loads them."""
    meta = json.loads((workdir / f"{name}.json").read_text())
    inputs, output, size_dict = ctt.load_instance(
        str(workdir / f"{name}.instance.json")
    )[:3]
    tree = ctt.load_tree(
        str(workdir / f"{name}.tree.json"), inputs, output, size_dict
    )
    with np.load(workdir / f"{name}.npz") as data:
        arrays = [data[f"a{i}"] for i in range(len(inputs))]
    return tree, arrays, meta


def _save(path, res):
    if isinstance(res, tuple):
        np.savez(path, m=res[0].numpy(), e=res[1].numpy())
    else:
        np.savez(path, x=res.numpy())


def _worker_main(workdir, world, rank):
    """One rank of the main launch: every case in ``cases.json``."""
    import torch

    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    active = pmesh.maybe_init_distributed(
        init_method=f"file://{workdir / 'store'}", world_size=world,
        rank=rank, device="cpu", timeout=COLLECTIVE_S,
    )
    assert active and torch.distributed.get_backend() == "gloo"
    mesh = pmesh.get_default_mesh(world, devices="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (rank, world, "cpu")
    for name in json.loads((workdir / "cases.json").read_text()):
        tree, arrays, meta = _port_case(ctt, workdir, name)
        pdt = getattr(torch, meta["plane_dtype"])
        opts = dict(strip_exponent=meta["strip"], plane_dtype=pdt)
        if meta["reassemble"]:
            res = pmesh.contract_sharded(tree, arrays, mesh=mesh, **opts)
        else:
            fn = pmesh.make_sharded_contractor(
                tree, mesh, reassemble=False, shard_chunks=True, **opts
            )
            res = fn(*ctt.to_tensors(arrays, "cpu", pdt))
        _save(workdir / f"{name}.rank{rank}.npz", res)
        if rank == 0 and meta["unsharded"]:
            # the port's own unsharded value on the same tree
            _save(
                workdir / f"{name}.unsharded.npz",
                ctt.contract_tree(tree, arrays, device="cpu",
                                  plane_dtype=pdt,
                                  strip_exponent=meta["strip"]),
            )
    torch.distributed.destroy_process_group()


def _multihost_main(workdir):
    """One rank of the launch that mirrors ``tests/test_multihost.py``:
    the group comes from the launcher's environment; only rank 0 plans
    the tree it broadcasts."""
    import torch

    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)
    assert pmesh.maybe_init_distributed(device="cpu", timeout=COLLECTIVE_S)
    mesh = pmesh.get_global_mesh()
    rank = mesh.rank
    assert (mesh.size, mesh.device.type) == (2, "cpu")
    assert mesh.rank == int(os.environ["RANK"])
    inputs, output, shapes, size_dict = ctt.rand_equation(12, 3, seed=0)
    arrays = [
        np.random.default_rng(i).normal(size=s)
        for i, s in enumerate(shapes)
    ]
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    if rank == 0:
        tree.slice_(target_slices=8)
    # the other rank's own tree differs: unsliced
    tree = pmesh.broadcast_tree(tree)
    got = tree.contract_sharded(
        arrays, mesh=mesh, plane_dtype=torch.float64
    )
    np.savez(
        workdir / f"multihost.rank{rank}.npz", x=got.numpy(),
        sliced=np.array(list(tree.sliced_inds)),
        children=np.array(sorted(tree.children.items()), dtype=object),
    )
    torch.distributed.destroy_process_group()


# -- the launches ----------------------------------------------------------


def _launch(workdir, args, envs):
    """Run one rank per entry of ``envs`` (extra environment) with
    ``--worker`` ``args``; kill them all at the first failure or after
    ``LAUNCH_LIMIT_S``."""
    procs, logs = [], []
    for k, extra in enumerate(envs):
        env = {**os.environ, "PYTHONPATH": str(ROOT), **extra}
        env.pop("LOCAL_RANK", None)
        logs.append(Path(workdir) / f"{args[0]}.rank{k}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker", *args],
                env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            ))
    deadline = time.monotonic() + LAUNCH_LIMIT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for k, (p, log) in enumerate(zip(procs, logs)):
        p.wait()
        assert p.returncode == 0, (
            f"rank {k} exited {p.returncode} (limit {LAUNCH_LIMIT_S} s):\n"
            + log.read_text(errors="replace")
        )


if __name__ == "__main__":
    _, mode, workdir, *rest = sys.argv[1:] or [None, None, None]
    if mode == "main":
        _worker_main(Path(workdir), int(rest[0]), int(os.environ["RANK"]))
    elif mode == "multihost":
        _multihost_main(Path(workdir))
    else:
        raise SystemExit(f"unknown worker mode {mode!r}")
    sys.exit(0)


# -- the reference side (pytest) ---------------------------------------------

import jax  # noqa: E402
import pytest  # noqa: E402

import cotengra_tpu as ctg  # noqa: E402
from cotengra_tpu.parallel.mesh import (  # noqa: E402
    contract_sharded,
    get_default_mesh,
    make_sharded_contractor,
)
from cotengra_tpu.utils.io import save_instance, save_tree  # noqa: E402


def _rand_tree(n, seed, n_out=0, d_min=2, d_max=3):
    inputs, output, shapes, size_dict = ctg.rand_equation(
        n, 3, n_out=n_out, seed=seed, d_min=d_min, d_max=d_max
    )
    tree = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    return tree, shapes


def _inner(seed):
    tree, shapes = _rand_tree(10, seed)
    tree.slice_(target_slices=8)
    rng = np.random.default_rng(seed)
    return tree, [rng.normal(size=s) for s in shapes]


def _output_chunks():
    tree, shapes = _rand_tree(10, 42, n_out=2)
    tree.slice_(target_slices=4, allow_outer="only")
    tree.slice_(target_slices=4 * tree.multiplicity)
    rng = np.random.default_rng(0)
    return tree, [rng.normal(size=s) for s in shapes]


def _stripped():
    tree, shapes = _rand_tree(9, 5)
    tree.slice_(target_slices=8)
    rng = np.random.default_rng(1)
    return tree, [10.0 * rng.normal(size=s) for s in shapes]


def _chunked(seed):
    tree, shapes = _rand_tree(12, seed, n_out=3)
    tree.slice_(target_slices=8, allow_outer="only")
    tree.slice_(target_slices=2 * tree.multiplicity)
    rng = np.random.default_rng(seed)
    return tree, [rng.normal(size=s) for s in shapes]


def _uneven():
    # slices of size 3: 27 inner slices over 4 ranks
    tree, shapes = _rand_tree(10, 8, d_min=3, d_max=3)
    tree.slice_(target_slices=27)
    rng = np.random.default_rng(2)
    return tree, [rng.normal(size=s) for s in shapes]


def _few_slices():
    # 2 slices over 4 ranks: two ranks have none
    tree, shapes = _rand_tree(10, 3)
    tree.slice_(target_slices=2)
    rng = np.random.default_rng(3)
    return tree, [rng.normal(size=s) for s in shapes]


def _tiny(dtype, n_sliced=2):
    """9 slices (two inner indices of size 3), or 3 (one), of a
    contraction of entries near ``TINY``: ~10^-55.6, which only a
    stripped float32 run holds."""
    tree, shapes = _rand_tree(10, 0)
    threes = sorted(ix for ix, d in tree.size_dict.items() if d == 3)
    for ix in threes[:n_sliced]:
        tree.remove_ind_(ix)
    assert tree.multiplicity == 3**n_sliced
    rng = np.random.default_rng(0)
    return tree, [
        (TINY * rng.uniform(0.5, 1.5, size=s)).astype(dtype) for s in shapes
    ]


# name -> (builder, strip_exponent, reassemble, plane dtype, unsharded)
CASES = {
    **{f"inner{s}": (lambda s=s: _inner(s), False, True, "float64", False)
       for s in range(3)},
    "output_chunks": (_output_chunks, False, True, "float64", False),
    "stripped": (_stripped, True, True, "float64", False),
    "chunk_axis": (lambda: _chunked(11), False, True, "float64", False),
    "chunk_axis_stripped": (lambda: _chunked(13), True, True, "float64",
                            False),
    "chunk_unassembled": (lambda: _chunked(17), False, False, "float64",
                          False),
    "chunk_unassembled_stripped": (lambda: _chunked(19), True, False,
                                   "float64", False),
    "uneven": (_uneven, False, True, "float64", False),
    "uneven_stripped": (_uneven, True, True, "float64", False),
    "few_slices": (_few_slices, False, True, "float64", False),
    "few_slices_stripped": (_few_slices, True, True, "float64", False),
    "tiny_float32": (lambda: _tiny(np.float32), True, True, "float32", True),
    "tiny_float64": (lambda: _tiny(np.float64), True, True, "float64", True),
    # 3 slices over 4 ranks: rank 3 adds nothing
    "tiny_few_float32": (lambda: _tiny(np.float32, 1), True, True, "float32",
                         True),
}


def _write_case(workdir, name, tree, arrays, strip, reassemble, pdt,
                unsharded):
    save_instance(
        str(workdir / f"{name}.instance.json"),
        tree.inputs, tree.output, tree.size_dict,
    )
    save_tree(str(workdir / f"{name}.tree.json"), tree)
    np.savez(workdir / f"{name}.npz",
             **{f"a{i}": a for i, a in enumerate(arrays)})
    (workdir / f"{name}.json").write_text(json.dumps({
        "strip": strip, "reassemble": reassemble, "plane_dtype": pdt,
        "unsharded": unsharded,
    }))


def _reference(tree, arrays, strip, reassemble, mesh):
    """The JAX package's sharded result, on the host."""
    if reassemble:
        res = contract_sharded(tree, arrays, mesh=mesh,
                               strip_exponent=strip)
    else:
        res = make_sharded_contractor(
            tree, mesh, strip_exponent=strip, reassemble=False,
            shard_chunks=True,
        )(*arrays)
    if strip:
        return np.asarray(res[0]), np.asarray(res[1])
    return np.asarray(res)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every case through the JAX package and through one launch of
    ``WORLD`` port ranks; the rank's results, the reference's, and the
    port's unsharded value where a case asks for it."""
    assert len(jax.devices()) == 8, "conftest should force 8 cpu devices"
    workdir = tmp_path_factory.mktemp("torch_mesh")
    mesh = get_default_mesh(WORLD)
    refs = {}
    for name, (build, strip, reassemble, pdt, unsharded) in CASES.items():
        tree, arrays = build()
        _write_case(workdir, name, tree, arrays, strip, reassemble, pdt,
                    unsharded)
        # the tree the ranks load, so that both sides slice alike
        inputs, output, size_dict = ctg.load_instance(
            str(workdir / f"{name}.instance.json")
        )[:3]
        rtree = ctg.load_tree(
            str(workdir / f"{name}.tree.json"), inputs, output, size_dict
        )
        refs[name] = _reference(rtree, arrays, strip, reassemble, mesh)
    (workdir / "cases.json").write_text(json.dumps(list(CASES)))
    _launch(
        workdir, ["main", str(workdir), str(WORLD)],
        [{"RANK": str(r)} for r in range(WORLD)],
    )

    def load(path):
        with np.load(path) as data:
            return (data["m"], data["e"]) if "m" in data else data["x"]

    got = {
        name: [load(workdir / f"{name}.rank{r}.npz") for r in range(WORLD)]
        for name in CASES
    }
    unsharded = {
        name: load(workdir / f"{name}.unsharded.npz")
        for name, case in CASES.items() if case[4]
    }
    return got, refs, unsharded


def _value(res):
    """A stripped pair as one value (float64; exponents differ between
    the two packages where the reference's padding lifts them)."""
    if isinstance(res, tuple):
        m, e = res
        e = np.asarray(e, np.float64)
        return np.asarray(m, np.complex128) * 10.0 ** e.reshape(
            e.shape + (1,) * (np.ndim(m) - np.ndim(e))
        )
    return res


def _log10(res):
    m, e = res
    return float(np.log10(abs(float(m))) + float(e))


SHARDED = [
    n for n, case in CASES.items() if case[2] and not n.startswith("tiny")
]


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_matches_the_reference(mesh_run, name):
    """Every rank's whole result equals the JAX package's (float64, rtol
    1e-10): inner slices, output chunks, stripped sums, the chunk axis,
    slice counts not a multiple of the ranks and more ranks than
    slices."""
    got, refs, _ = mesh_run
    exp = _value(refs[name])
    for rank, res in enumerate(got[name]):
        assert isinstance(res, tuple) == CASES[name][1], rank
        np.testing.assert_allclose(
            _value(res), exp, rtol=1e-10, atol=0, err_msg=f"rank {rank}"
        )


@pytest.mark.parametrize(
    "name", ["chunk_unassembled", "chunk_unassembled_stripped"]
)
def test_unassembled_stack_is_the_ranks_shard(mesh_run, name):
    """``reassemble=False``: rank ``r``'s stack is the rows of the JAX
    package's result on device ``r``'s shard (rows past the last chunk
    zero)."""
    got, refs, _ = mesh_run
    exp = _value(refs[name])
    n_per = exp.shape[0] // WORLD
    for rank, res in enumerate(got[name]):
        mine = _value(res)
        assert mine.shape == (n_per,) + exp.shape[1:], rank
        np.testing.assert_allclose(
            mine, exp[rank * n_per:(rank + 1) * n_per], rtol=1e-10, atol=0,
            err_msg=f"rank {rank}",
        )


@pytest.mark.parametrize("name,atol", [("tiny_float32", 1e-5),
                                       ("tiny_few_float32", 1e-5),
                                       ("tiny_float64", 1e-10)])
def test_stripped_tiny_values_survive_uneven_ranks(mesh_run, name, atol):
    """9 (or 3) slices over 4 ranks, stripped, at ~10^-55.6: every rank's
    value equals the port's unsharded one. The reference's padded slot
    adds ``(0, 0)``, which lifts the exponent's maximum to 0 and flushes
    the float32 mantissa to zero (ROADMAP C); a rank of the port without
    a slice adds mantissa 0 at exponent -inf."""
    got, refs, unsharded = mesh_run
    want = _log10(unsharded[name])
    assert want < -38  # below float32's range unstripped
    for rank, res in enumerate(got[name]):
        assert abs(_log10(res) - want) <= atol, (rank, _log10(res), want)
    if name.endswith("float32"):
        assert float(refs[name][0]) == 0.0  # the reference's fault
    else:
        # float64 holds 10^-55.6 after the reference's rescale
        assert abs(_log10(refs[name]) - want) <= 1e-10


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_ranks_from_the_environment(tmp_path):
    """The mirror of ``tests/test_multihost.py``: two processes join from
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` through
    ``maybe_init_distributed``, take ``get_global_mesh``, contract the
    tree that only rank 0 planned (``broadcast_tree``), and agree with
    numpy."""
    port = _free_port()
    _launch(
        tmp_path, ["multihost", str(tmp_path)],
        [
            {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "RANK": str(r), "WORLD_SIZE": "2"}
            for r in range(2)
        ],
    )
    inputs, output, shapes, _ = ctg.rand_equation(12, 3, seed=0)
    arrays = [
        np.random.default_rng(i).normal(size=s)
        for i, s in enumerate(shapes)
    ]
    exp = np.einsum(
        ctg.utils.inds_to_eq(inputs, output), *arrays, optimize=True
    )
    runs = [
        np.load(tmp_path / f"multihost.rank{r}.npz", allow_pickle=True)
        for r in range(2)
    ]
    for r, run in enumerate(runs):
        np.testing.assert_allclose(run["x"], exp, rtol=1e-10)
        assert len(run["sliced"]) > 0, r  # rank 1 took rank 0's slicing
        assert run["sliced"].tolist() == runs[0]["sliced"].tolist()
        assert run["children"].tolist() == runs[0]["children"].tolist()
