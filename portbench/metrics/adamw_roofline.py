"""AdamW's share of its bytes bound: 7 float32 streams of a silo's row
(gradient, two slots and parameters read; two slots and parameters
written) at 3.35 TB/s, over the CUDA-event time of the window's
``Optimizer.update`` calls."""

from portbench.yardstick import PEAK_HBM_BYTES


def read(rec):
    opt = rec.get("optimizer")
    if not opt or opt["seconds"] <= 0:
        return None
    return 100.0 * opt["bytes"] / PEAK_HBM_BYTES / opt["seconds"]
