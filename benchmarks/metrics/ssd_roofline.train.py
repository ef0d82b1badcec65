"""ssd_roofline.train: S1's share of its own roofline in train cells: the
least time of the scan's work over the window's steps (the definition's
`ssd_work(model, batch, seq, train)`, counts.bound_s at the card's peaks)
over the device time of S1's kernels, the kernels whose names hold one of
MARKS (`ssd_fwd_kernel`, `ssd_bwd_state_kernel`, `ssd_bwd_chunk_kernel`
in csrc/ssd.cu), as a share (%). None where the definition counts no scan
work, the card has no peak, or the window ran no S1 kernel."""

from harness.counts import bound_s

MARKS = ("ssd_fwd_kernel", "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel")


def read(view):
    work = getattr(view.definition, "ssd_work", None)
    if view.kind != "train" or work is None or view.peak is None \
            or not view.units:
        return None
    ns = sum(end - start for name, start, end in view.events.device
             if any(mark in name for mark in MARKS))
    if not ns:
        return None
    bound = sum(bound_s(work(view.model, b, s, train=True), view.peak)
                for b, s, _ in view.units)
    return 100.0 * bound / (ns / 1e9)
