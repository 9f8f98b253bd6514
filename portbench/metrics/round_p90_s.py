"""The 90th percentile of all the window's round times (host clock; a
round runs from its start to the next round's start, so a re-design or a
migration after a round counts in that round)."""

from portbench.yardstick import percentile


def read(rec):
    if not rec.get("round_s"):
        return None
    return percentile(rec["round_s"], 90)
