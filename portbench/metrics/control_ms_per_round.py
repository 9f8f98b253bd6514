"""Mean host time of the program's ``train.control`` span (the
controller's ``observe_round`` and the slot swaps) over the window's
rounds in which no ``controller.redesign`` ran, in ms."""


def read(rec):
    times = [c["s"] for c in rec.get("control_spans") or () if not c["redesign"]]
    return 1e3 * sum(times) / len(times) if times else None
