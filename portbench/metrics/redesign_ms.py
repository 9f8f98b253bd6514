"""Mean host wall time of the controller's re-designs in the traced run
(the program's ``controller.redesign_s`` histogram), in ms."""


def read(rec):
    mean = rec.get("redesign_mean_s")
    return None if mean is None else 1e3 * mean
