"""CUDA-event time of the program's ``step.mix`` span per round (the
round's mix whatever the lowering: its stack, the host-to-device copies
of weights, permutations or matrix, and the combine), over the window's
unprofiled rounds, in ms."""

from portbench.spans import per_round_ms


def read(rec):
    return per_round_ms(rec, "mix_s")
