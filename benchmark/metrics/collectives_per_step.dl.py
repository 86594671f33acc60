"""collectives_per_step.dl: the all-reduces the program's captured train
step holds (``GraphedCall.collectives``, counted by
``core/distributed.py::all_reduce`` at the capture; a replay runs them
again): a forward and a backward one a batch norm and one for the
gradients.  None where the program keeps no such record."""


def read(run):
    return run.counters.get("collectives_per_step")
