"""idle_share (%; layer device): 1 - (union of device intervals) / traced
window, in percent; on a mesh, of rank 0's card, the one whose host does
the save while the other ranks wait for it in an NCCL kernel (which
counts as busy on their cards)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
