"""Local BA iterations a keyframe event of the host Tracker over the untraced passes: System's counts `#lba_iterations` (the Tracker's `ScanCounters.ba_iterations`) over `#kf_events`. 0 where no window holds a landmark seen twice; None where the program has no such counts."""


def read(ctx):
    t = ctx["timings"]
    if not t.get("#kf_events") or "#lba_iterations" not in t:
        return None
    return t["#lba_iterations"] / t["#kf_events"]
