"""Slice → torch `DeviceMesh` mapping.

Port of `tpu_device_plugin/validator/mesh.py`. Axes: `dp` (data parallel,
gradient all-reduce), `sp` (sequence parallel: ring attention or a K/V
all-gather), `tp` (tensor parallel over heads and the MLP's hidden units),
and two optional axes, `pp` (pipeline stages) and `ep` (experts), which
appear only when larger than 1. Axis order, outermost to innermost: pp, dp,
sp, ep, tp, so tp's collectives join neighbouring ranks (on one host,
neighbouring cards).

`slice_mesh` needs the default process group (`distributed.spawn`, or
`torch.distributed.init_process_group`) with one rank per device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def infer_mesh_shape(n_devices: int,
                     tp: Optional[int] = None,
                     sp: Optional[int] = None) -> Tuple[int, int, int]:
    """Factor `n_devices` into (dp, sp, tp).

    Defaults: tp takes the largest power-of-two ≤ min(n, 4) (one host's worth
    of nearest-neighbor links), sp stays 1 unless asked, dp absorbs the rest.
    """
    if tp is None:
        tp = 1
        while tp * 2 <= min(n_devices, 4) and n_devices % (tp * 2) == 0:
            tp *= 2
    if sp is None:
        sp = 1
    if n_devices % (tp * sp) != 0:
        raise ValueError(f"{n_devices} devices not divisible by tp={tp} * sp={sp}")
    dp = n_devices // (tp * sp)
    return dp, sp, tp


def mesh_dims(n_devices: int,
              tp: Optional[int] = None,
              sp: Optional[int] = None,
              pp: Optional[int] = None,
              ep: Optional[int] = None) -> List[Tuple[str, int]]:
    """The (axis, size) pairs of `slice_mesh`'s mesh, outermost first:
    pp, dp, sp, ep, tp, with pp and ep only when > 1. Raises ValueError
    where the sizes do not divide `n_devices`."""
    pp = pp or 1
    ep = ep or 1
    if n_devices % (pp * ep) != 0:
        raise ValueError(f"{n_devices} devices not divisible by pp={pp} * ep={ep}")
    dp, sp_, tp_ = infer_mesh_shape(n_devices // (pp * ep), tp=tp, sp=sp)
    dims = [("pp", pp), ("dp", dp), ("sp", sp_), ("ep", ep), ("tp", tp_)]
    return [(name, size) for name, size in dims
            if size > 1 or name in ("dp", "sp", "tp")]


def slice_mesh(n_devices: int = 1,
               tp: Optional[int] = None,
               sp: Optional[int] = None,
               pp: Optional[int] = None,
               ep: Optional[int] = None,
               device_type: str = "cuda"):
    """A `DeviceMesh` over the `n_devices` ranks of the default group.

    Axis order (outermost→innermost): pp, dp, sp, ep, tp — pp/ep included
    only when > 1, so the default is the 3-axis ("dp", "sp", "tp") mesh.
    """
    dims = mesh_dims(n_devices, tp, sp, pp, ep)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(size for _, size in dims),
                            mesh_dim_names=tuple(name for name, _ in dims))


def mesh_shape(mesh) -> dict:
    """{axis name: size}, in the mesh's axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
