"""Each flash kernel's share of its own roofline, for the per-kernel
readers (`metrics/flash_*_roofline.train.py`).

Where a configuration's definition gives the work of each flash kernel
(`attention_work_by_kernel(model, batch, seq, train)` -> {kernel group:
[Work]}, the groups of trace.py: `flash_fwd`, `flash_bwd_dkv`,
`flash_bwd_dq`), a kernel's share is the least time of its work over the
window's flash steps or requests (counts.bound_s at the card's peaks)
over the device time of that kernel's group, as a share (%). None for
another kind of cell, a definition without per-kernel work, a card
without a peak, or a window in which the kernel did not run.
"""

from __future__ import annotations

from typing import Optional

from .counts import bound_s


def roofline(view, kernel: str, kind: str) -> Optional[float]:
    by_kernel = getattr(view.definition, "attention_work_by_kernel", None)
    if view.kind != kind or by_kernel is None or view.peak is None:
        return None
    spent = view.seconds(kernel)
    flash = [(b, s) for b, s, mode in view.units if mode == "flash"]
    if spent <= 0 or not flash:
        return None
    bound = sum(bound_s(by_kernel(view.model, b, s,
                                  train=kind == "train").get(kernel, []),
                        view.peak)
                for b, s in flash)
    return 100.0 * bound / spent
