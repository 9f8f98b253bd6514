"""Every token that every active silo trained on in the window's rounds,
over the window's wall time (host clock, first round's start to the last
round's end)."""


def read(rec):
    if not rec.get("round_s"):
        return None
    return sum(rec["tokens"]) / rec["window_s"]
