"""The gossip mix's share of its bytes bound: the round plan's K rows
read and one written, (K + 1) n P float32 bytes a round at 3.35 TB/s,
over the device time of the profiled rounds' ``gossip_mix`` kernels."""

from portbench.yardstick import PEAK_HBM_BYTES, part_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("mix_bytes"):
        return None
    sec = part_seconds(prof, "gossip_mix kernel")
    return 100.0 * prof["mix_bytes"] / PEAK_HBM_BYTES / sec if sec > 0 else None
