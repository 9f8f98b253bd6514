"""The share of the profiled rounds' wall time in which no operation ran
on the device, in %."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
