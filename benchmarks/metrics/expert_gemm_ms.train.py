"""expert_gemm_ms.train: device ms a training step in the grouped expert
products of a dropless MoE (the port's `torch._grouped_mm` over the
experts held), forward, recomputed and backward: the kernels whose names
hold one of MARKS. On an H100 with torch 2.11 (cu128) the products run as
`cutlass::device_kernel<...GemmUniversal<GroupProblemShape<...>...>>`
(CUTLASS 3's sm90 pointer-array grouped GEMM), each launch after a
`prepare_grouped_gemm_data` kernel that writes its problem list. None
where the window has none (a block without them)."""

MARKS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(view):
    if view.kind != "train" or not view.units:
        return None
    ns = sum(end - start for name, start, end in view.events.device
             if any(mark in name for mark in MARKS))
    return 1e-6 * ns / len(view.units) if ns else None
