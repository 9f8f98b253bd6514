"""Model FLOPs of the tokens trained in the window's rounds outside the
profiled ones, over those rounds' time, as a share of the card's dense
TF32 peak (495 TFLOP/s, the fastest unit that takes float32 operands).
FLOPs per token: three times the forward's matrix products (the
yardstick's copy of the analytic model), recomputation not counted."""

from portbench.yardstick import PEAK_TF32_FLOPS


def read(rec):
    rounds = rec.get("round_s")
    if not rounds:
        return None
    skip = set(rec.get("profiled", ()))
    keep = [i for i in range(len(rounds)) if i not in skip]
    seconds = sum(rounds[i] for i in keep)
    if not keep or seconds <= 0:
        return None
    tokens = sum(rec["tokens"][i] for i in keep)
    return 100.0 * tokens * rec["flops_per_token"] / seconds / PEAK_TF32_FLOPS
