"""One module per metric: ``read(record) -> value or None``."""
