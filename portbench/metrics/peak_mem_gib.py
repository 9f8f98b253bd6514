"""The device's allocated peak over the window (``max_memory_allocated``
after ``reset_peak_memory_stats`` at the window's start; the live state
counts), in GiB."""


def read(rec):
    if not rec.get("peak_bytes"):
        return None
    return rec["peak_bytes"] / 2 ** 30
