"""From the process's start (the kernel's record of it) to the start of
the window's first round: imports, kernel loads, weights, design, and the
check rounds that warm every shape."""


def read(rec):
    return rec.get("setup_s")
