"""CUDA-event time of the program's ``step.optimizer`` spans per round
(every ``Optimizer.update``: AdamW or momentum), over the window's
unprofiled rounds, in ms."""

from portbench.spans import per_round_ms


def read(rec):
    return per_round_ms(rec, "optimizer_s")
