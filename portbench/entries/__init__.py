"""One module per entry kind: ``run(ctx) -> record``."""
