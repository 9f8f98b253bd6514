"""Mean of the program's ``train.migrate`` spans over the window's
migrations (the re-stack of the state between two device syncs: the
interval of the migration's logged ``wall_s``), in ms."""


def read(rec):
    times = rec.get("migrate_spans_s")
    return 1e3 * sum(times) / len(times) if times else None
