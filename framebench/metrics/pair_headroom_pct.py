"""The least pair headroom of the window, in %: 100 x the least (1 - demand
/ budget) over its frames, their passes (the frame's and the sun band's)
and each pass's pair budgets -- the tiny2, small, midA, midB and giant
classes' triangles and the live pairs against pair_capacity
(raster_tile.count_pairs' counters)."""


def read(run):
    shares = [1.0 - v / b for f in run.stages or [] for name, (values, bases) in f.get("counters", {}).items()
              if name.endswith((" pairs", " pair classes")) for v, b in zip(values, bases) if b > 0]
    return 100.0 * min(shares) if shares else None
