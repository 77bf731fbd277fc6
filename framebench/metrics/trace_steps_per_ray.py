"""The BVH walk's mean steps a ray over the window (shadow_pass's "rt
steps" counter: steps against rays)."""


def read(run):
    counts = [f["counters"]["rt steps"] for f in run.stages or [] if "rt steps" in f.get("counters", {})]
    rays = sum(b for _, (b,) in counts)
    return sum(v for (v,), _ in counts) / rays if rays else None
