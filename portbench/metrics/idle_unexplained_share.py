"""Device: of the card's idle time in the profiled sub-window (its
bounds less the merged busy intervals ``sub["busy_ns"]``, on kineto's
clock), the share in % during which no span of the program was open on
any thread, the program's spans mapped onto that clock through the
snapshot's clock pair. Moves ``frames_per_s``."""
from ..profiling import _union
from ._spans import spans

UNIT = "%"


def _minus(a, b):
    """The merged intervals ``a`` less the merged intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def read(ctx):
    sub, ss = ctx.get("sub"), spans(ctx)
    if not sub or "busy_ns" not in sub or ss is None or ctx.get("sub_t0") is None:
        return None
    perf, epoch = ctx["program"]["clock"]
    shift = epoch - perf
    lo = int(ctx["sub_t0"] * 1e9) + shift
    hi = int(ctx["sub_t1"] * 1e9) + shift
    idle = _minus([(lo, hi)], [(max(s, lo), min(e, hi))
                               for s, e in sub["busy_ns"] if e > lo and s < hi])
    idle_ns = sum(e - s for s, e in idle)
    if idle_ns <= 0:
        return None
    _, covered = _union([(s.t0_ns + shift, s.t1_ns + shift) for s in ss])
    unexplained = sum(e - s for s, e in _minus(idle, covered))
    return 100.0 * unexplained / idle_ns
