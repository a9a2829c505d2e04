"""The share of the window's TrajDiT forwards that replayed a CUDA graph of
the trunk, in % (the tracer's ``graphs`` counter: ``replayed`` over
``replayed`` and ``eager``). None where the program keeps no such counter
or ran no TrajDiT forward."""
from portbench.metrics import _spans


def read(ctx: dict):
    rec = _spans.recording()
    got = rec[1].get("graphs", {}).get("traj") if rec else None
    if not got:
        return None
    calls = got["replayed"] + got["eager"]
    return 100.0 * got["replayed"] / calls if calls else None
