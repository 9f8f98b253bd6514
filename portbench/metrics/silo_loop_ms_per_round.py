"""Host wall time of the program's ``step.local`` spans per round (one a
silo: its forwards, backwards and updates as the host issues them,
including every wait on the card inside, such as a launch into a full
queue or an allocation), over the window's unprofiled rounds, in ms. It
is not the time to queue a round: where the card is the bottleneck the
host waits inside the loop, and this reads close to the round."""

from portbench.spans import per_round_ms


def read(rec):
    return per_round_ms(rec, "local_s")
