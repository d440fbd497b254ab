"""The benchmark's pieces, found by name.

``BENCHMARK.json`` at the checkout's root names each cell (workload), its
configuration, its traffic mix and its chips, and lists the metrics.  Every
piece a cell needs sits in a file of its own under ``perfbench/``:

* ``configs/<config>.json``: the configuration as run (sizes under the
  source's own keys, the port's ``ArchConfig`` fields that build it, what was
  cut, assumed or left out, the precision it states, and the file of its
  plain reference model), and ``configs/<config>.py`` beside it, its
  model-FLOPs count;
* ``traffic/<traffic>.json``: the training job: mode, exchange settings,
  workers, rows a worker, sequence and frame lengths, learning rate, and the
  steps the reference follows;
* ``limits/<cell>.json``: the limit of each number that decides ``correct``,
  with the readings it was set from;
* ``metrics/<metric>.py``: one reader a per-layer metric (``read(record)``).

Nothing here imports the program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module loaded from ``path`` (names may hold dots, so no import)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: str = ROOT) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Config:
    name: str
    data: Dict
    flops: Callable  # model_flops(arch, rows, seq, frames) -> one worker's step

    @property
    def arch(self) -> Dict:
        """The port's ``ArchConfig`` fields, every size stated."""
        return dict(self.data["arch"])

    def reference(self):
        """The plain reference model the file names (``loss`` and
        ``leaf_shapes``)."""
        path = os.path.join(ROOT, self.data["reference"])
        return load_module(path, "perfbench_reference_" + os.path.basename(path)[:-3])


@dataclasses.dataclass
class Traffic:
    name: str
    data: Dict

    @property
    def mode(self) -> str:
        return self.data["mode"]

    @property
    def workers(self) -> int:
        return int(self.data["workers"])

    @property
    def rows(self) -> int:
        return int(self.data["batch_per_worker"])

    @property
    def seq(self) -> int:
        return int(self.data["seq"])

    @property
    def warmup_steps(self) -> int:
        return int(self.data["warmup_steps"])


@dataclasses.dataclass
class Cell:
    name: str
    config: Config
    traffic: Traffic
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict

    def frames(self) -> int:
        """Frontend positions a row: an audio frontend takes the traffic's
        frames, a configuration without one none."""
        return int(self.traffic.data["frames"]) if self.config.arch.get(
            "frontend", "none") == "audio_frames" else 0

    def tokens_per_step(self) -> int:
        """Training tokens of one step over every worker (a decoder's target
        tokens; frames are input)."""
        return self.traffic.workers * self.traffic.rows * self.traffic.seq


def load_config(name: str) -> Config:
    data = _load_json(os.path.join(HERE, "configs", f"{name}.json"))
    mod = load_module(os.path.join(HERE, "configs", f"{name}.py"), f"perfbench_config_{name}")
    return Config(name, data, mod.model_flops)


def load_traffic(name: str) -> Traffic:
    return Traffic(name, _load_json(os.path.join(HERE, "traffic", f"{name}.json")))


def load_limits(cell: str) -> Dict:
    return _load_json(os.path.join(HERE, "limits", f"{cell}.json"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(entries)}")
    w = entries[name]
    traffic = load_traffic(w["traffic"])
    if traffic.workers != int(w["chips"]):
        raise ValueError(f"{name}: traffic {traffic.name} runs {traffic.workers} workers, "
                         f"the cell asks for {w['chips']} chips")
    return Cell(name, load_config(w["config"]), traffic, int(w["chips"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                load_limits(name))


def base_name(name: str) -> str:
    """A metric's quantity: a name split by the cells it is reported in
    (``mfu.x4``) is ``mfu``'s quantity; a name of its own file is itself."""
    while name not in reader_names() and "." in name:
        name = name.rsplit(".", 1)[0]
    return name


def metric_reader(name: str) -> Callable:
    """``read(record) -> value or None`` of a per-layer metric: its own file
    ``metrics/<name>.py``, else its quantity's (:func:`base_name`)."""
    base = base_name(name)
    path = os.path.join(HERE, "metrics", f"{base}.py")
    return load_module(path, "perfbench_metric_" + base.replace(".", "_")).read


def reader_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(os.path.join(HERE, "metrics"))
                  if f.endswith(".py") and not f.startswith("_"))

