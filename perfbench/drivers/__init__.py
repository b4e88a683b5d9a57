"""Traffic drivers: each runs one kind of traffic mix against the program.
A mix names its driver, a module of this package, in its ``driver`` key;
the harness finds it by that name and holds it to this contract.

Every driver defines:

- ``setup(cell, seed, device, fault=None) -> state``: the program's data,
  weights and entry built from the seed and warmed up (``fault`` plants
  one of the faults the cell can have);
- ``window(state, seconds, trace=None) -> record``: the measured window,
  the cell's end-to-end metrics and ``attempted`` / ``failed`` in the
  record, ``trace`` (:class:`perfbench.tracing.Trace`) started and stopped
  inside it;
- ``release(state)``: the program's state freed, what the comparison
  needs kept;
- ``check(state) -> numbers``: the numbers compared with the cell's
  limits.

A training driver also defines ``reference_readings(state, prec)``, the
plain reference's readings over the first steps in precision ``prec``,
and ``compare(program, reference) -> numbers``, and its ``release`` leaves
the program's readings in ``state["program"]``: ``perfbench/control.py``
compares the reference at the control precision through them.  A driver
of another architecture's training step may import ``Feed``, ``window``,
``release`` and ``compare`` from :mod:`perfbench.drivers.train_loop`.
"""

RUN = ("setup", "window", "release", "check")
TRAINING = ("reference_readings", "compare")


def is_training(driver) -> bool:
    return hasattr(driver, "reference_readings")


def missing(driver) -> list:
    """The names of the contract that the module ``driver`` does not
    define as functions."""
    want = RUN + (TRAINING if is_training(driver) else ())
    return [name for name in want
            if not callable(getattr(driver, name, None))]
