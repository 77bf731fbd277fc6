"""The transmission layer's least headroom over the window, in %: 100 x the
least (1 - demand / budget) over its frames of the layer pass's pair
budgets ("glass pairs", "glass pair classes": raster_tile.count_pairs) and
its surviving clusters against late_cluster_capacity ("glass clusters")."""

NAMES = ("glass pairs", "glass pair classes", "glass clusters")


def read(run):
    shares = [1.0 - v / b for f in run.stages or [] for name, (values, bases) in f.get("counters", {}).items()
              if name in NAMES for v, b in zip(values, bases) if b > 0]
    return 100.0 * min(shares) if shares else None
