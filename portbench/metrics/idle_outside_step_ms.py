"""Device idle time in the named round (the window that traced the host
as well, from the profiler's start to its stop) while no ``step`` span of
the program was open on the host, in ms (``portbench.spans.idle_split``)."""


def read(rec):
    split = rec.get("idle_split")
    return None if not split else 1e3 * split["outside_step_s"]
