"""tile_fill: real document bytes over the bytes of the padded tiles the
facade handed to its executor (rows x width), in percent.  Counted by the
benchmark's wrapper around the matcher's ``executor.run`` in the traced
run."""


def read(run):
    tiles = run.counters.get("tile_bytes", 0)
    if not tiles:
        return None
    return 100.0 * run.counters["real_bytes"] / tiles
