"""Convergence lab (port of ``repro.lab``): the paper's accuracy
statements (Fig. 11/12, Thm 3.4/3.5, Assumption 3.1) as executable,
regression-gated checks on the port.

* ``spec``     — declarative :class:`ExperimentSpec` (model x compressor x
  transport x theta-schedule x worker count) and the smoke/full/chaos
  matrices;
* ``runner``   — drives ``train_loop`` for each row (in-process with one
  worker, one spawned process a worker otherwise) while recording per-step
  loss / grad-energy / compression ratio / modeled wire, plus an
  Assumption 3.1 probe on live gradients;
* ``evaluate`` — asserts the paper's claims against the recorded curves;
* ``report``   — writes the JSON artifact and the results table;
* ``run``      — ``python -m repro_torch.lab.run [--smoke|--chaos]`` CLI.
"""

from repro_torch.lab.spec import ExperimentSpec, full_matrix, smoke_matrix  # noqa: F401

__all__ = ["ExperimentSpec", "smoke_matrix", "full_matrix"]
