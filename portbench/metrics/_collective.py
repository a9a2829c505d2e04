"""Shared by the collective readers: the NCCL kernels of each rank's own
trace of the window (``ctx["ranks"]``, a run over several cards). The
ranks launch the same collectives in the same order, so the k-th NCCL
kernel of every rank is one collective: its shortest duration over the
ranks is that of the rank that came last and waited least, close to the
transfer itself; what the others spent beyond it, they waited for it.
Where the ranks' counts differ, the rank with the least NCCL time stands
for the transfer. A run on one card reads None."""


def split_s(ctx: dict):
    """``(transfer_s, [each rank's NCCL seconds])`` over the window, or
    None."""
    calls = [r.get("collectives") or [] for r in ctx.get("ranks") or []]
    if not calls or not all(calls):
        return None
    totals = [sum(c) for c in calls]
    if len({len(c) for c in calls}) == 1:
        transfer = sum(min(k) for k in zip(*calls))
    else:
        transfer = min(totals)
    return transfer, totals


def transfer_ms_per_step(ctx: dict):
    got = split_s(ctx)
    if got is None or not ctx.get("work"):
        return None
    return 1e3 * got[0] / ctx["work"]


def wait_ms_per_step(ctx: dict):
    got = split_s(ctx)
    if got is None or not ctx.get("work"):
        return None
    transfer, totals = got
    return 1e3 * (sum(totals) / len(totals) - transfer) / ctx["work"]
