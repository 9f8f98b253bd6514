"""Device time of the matrix-product kernels per profiled round, in ms
(``torch.profiler``; kernels classed by name)."""

from portbench.yardstick import part_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    sec = part_seconds(prof, "matrix products")
    return 1e3 * sec / prof["rounds"] if sec > 0 else None
