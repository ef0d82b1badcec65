"""The port's mesh (mesh.py) and its process launcher (distributed.spawn).

`infer_mesh_shape` is held to the cases of test_validator.py, and
`slice_mesh`'s axis names and shapes to the JAX mesh's, over 8 and 4 gloo
processes (one spawn each; the children import this module). A child that
raises, or outlives its deadline, fails the caller quickly and leaves no
process behind.
"""

import re
import time

import pytest
import torch

from tpu_device_plugin_torch.validator import distributed
from tpu_device_plugin_torch.validator.mesh import (infer_mesh_shape,
                                                    mesh_shape, slice_mesh)

# (slice_mesh keyword arguments, axis names, shape) over 8 processes, as
# test_validator.py's JAX meshes
MESHES_8 = [
    (dict(tp=2, sp=2), ("dp", "sp", "tp"), (2, 2, 2)),
    (dict(), ("dp", "sp", "tp"), (2, 1, 4)),
    (dict(pp=2, ep=2, tp=2, sp=1), ("pp", "dp", "sp", "ep", "tp"),
     (2, 1, 1, 2, 2)),
    (dict(pp=1, ep=1), ("dp", "sp", "tp"), (2, 1, 4)),
    (dict(ep=2), ("dp", "sp", "ep", "tp"), (1, 1, 2, 4)),
    (dict(pp=2, tp=1, sp=1), ("pp", "dp", "sp", "tp"), (2, 4, 1, 1)),
]
MESHES_4 = [
    (dict(), ("dp", "sp", "tp"), (1, 1, 4)),
    (dict(tp=1, sp=4), ("dp", "sp", "tp"), (1, 4, 1)),
    (dict(tp=2, sp=1), ("dp", "sp", "tp"), (2, 1, 2)),
]


def test_infer_mesh_shape_defaults():
    assert infer_mesh_shape(8) == (2, 1, 4)
    assert infer_mesh_shape(4) == (1, 1, 4)
    assert infer_mesh_shape(1) == (1, 1, 1)
    assert infer_mesh_shape(8, tp=2, sp=2) == (2, 2, 2)
    with pytest.raises(ValueError):
        infer_mesh_shape(6, tp=4)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_infer_mesh_shape_matches_jax(n):
    jax_mesh = pytest.importorskip("tpu_device_plugin.validator.mesh")
    for tp in (None, 1, 2, 4):
        for sp in (None, 1, 2):
            try:
                want = jax_mesh.infer_mesh_shape(n, tp, sp)
            except ValueError as exc:
                with pytest.raises(ValueError, match=re.escape(str(exc))):
                    infer_mesh_shape(n, tp, sp)
                continue
            assert infer_mesh_shape(n, tp, sp) == want


def test_slice_mesh_refuses_indivisible_sizes_before_any_group():
    with pytest.raises(ValueError, match="not divisible by pp"):
        slice_mesh(6, pp=4, device_type="cpu")
    with pytest.raises(ValueError, match="not divisible by pp"):
        slice_mesh(6, ep=4, device_type="cpu")
    with pytest.raises(ValueError, match="not divisible by tp"):
        slice_mesh(6, tp=4, device_type="cpu")


def _mesh_worker(rank, spawned_mesh, n, meshes):
    """Each mesh's axis names, shape, this rank's coordinates and the
    shape of its shard of `wq` from a training build of a 4-expert MoE on
    it; the mesh spawn built and the rank's intra-op threads."""
    from tpu_device_plugin_torch.validator.workload import (ModelConfig,
                                                            build_workload)
    out = []
    for kw, _, _ in meshes:
        mesh = slice_mesh(n, device_type="cpu", **kw)
        _, params, _, _ = build_workload(
            ModelConfig(n_layers=2, batch=8, n_experts=4), mesh, device="cpu")
        out.append((mesh.mesh_dim_names, tuple(mesh.mesh.shape),
                    tuple(mesh.get_coordinate()),
                    tuple(params["layers"]["wq"].shape)))
    return out, mesh_shape(spawned_mesh), torch.get_num_threads()


@pytest.mark.parametrize("n,meshes", [(8, MESHES_8), (4, MESHES_4)])
def test_slice_mesh_axes_over_processes(n, meshes):
    per_rank = distributed.spawn(_mesh_worker, n, "cpu", timeout_s=120,
                                 args=(n, meshes), mesh=dict(tp=1, sp=2))
    for _, spawned, threads in per_rank:
        assert spawned == {"dp": n // 2, "sp": 2, "tp": 1}
        assert threads == 1
    per_rank = [out for out, _, _ in per_rank]
    for i, (_, names, shape) in enumerate(meshes):
        coords = set()
        sizes = dict(zip(names, shape))
        for rank_out in per_rank:
            got_names, got_shape, coord, wq = rank_out[i]
            assert got_names == names and got_shape == shape
            coords.add(coord)
            # the layers cut over pp, the heads over tp
            assert wq == (2 // sizes.get("pp", 1), 128, 128 // sizes["tp"])
        # every rank holds one place on the mesh, tp innermost
        assert len(coords) == n
        assert per_rank[1][i][2][-1] == (1 if shape[-1] > 1 else 0)


def _fails_on_rank_1(rank, _mesh):
    if rank == 1:
        raise KeyError("rank 1 gave up")
    time.sleep(600)   # the others would wait for it


def _hangs(rank, _mesh):
    time.sleep(600)


def _child_pids():
    import multiprocessing
    return [p.pid for p in multiprocessing.active_children()]


@pytest.mark.parametrize("fn,error,match,timeout_s", [
    (_fails_on_rank_1, KeyError, "rank 1 gave up", 60),
    (_hangs, TimeoutError, "still running", 5),
])
def test_spawn_fails_fast_and_leaves_no_process(fn, error, match, timeout_s):
    t0 = time.monotonic()
    with pytest.raises(error, match=match) as info:
        distributed.spawn(fn, 3, "cpu", timeout_s=timeout_s)
    # the failure ends the run at once, the hang at its deadline
    assert time.monotonic() - t0 < min(timeout_s, 20) + 10
    if error is KeyError:
        # the child's traceback comes along
        assert "process 1" in str(info.value.__cause__)
        assert "_fails_on_rank_1" in str(info.value.__cause__)
    assert _child_pids() == []
