"""A cell of ``BENCHMARK.json``, resolved from its files by name.

* ``configs/<config>.json`` (the ``file`` that ``BENCHMARK.json`` names):
  the deployment: fleet, protocol and its parameters, guarantees;
* ``mixes/<traffic>.json``: the traffic: Table II shares, offered load,
  replicas, chunking of the window, replicas checked;
* ``cells/<workload>.json``: what the cell adds to the pair: the scheduler;
* ``protocols/<protocol>.py`` and ``reference/<protocol>.py``: the
  protocol's stream, its reading of the program's state and its plain
  reference.

A later cell adds files; nothing here names a cell.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Optional

import numpy as np

from portbench.reference.common import Fleet, Rules, steady_params

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    scheduler: str
    fleet: Fleet
    rules: Rules
    T: int
    warm: int
    meas: int
    rate: float

    @property
    def protocol(self) -> str:
        return self.config["protocol"]["name"]

    @property
    def defrag(self) -> bool:
        return self.scheduler.endswith("-defrag")

    def module(self, kind: str):
        """``protocols/<protocol>.py`` or ``reference/<protocol>.py``."""
        return importlib.import_module(f"portbench.{kind}.{self.protocol}")


def load(workload: str, overrides: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """Resolve ``workload`` of ``root/BENCHMARK.json``; ``overrides``
    replaces mix entries (the tests run a cell at a small size)."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(root / cfg_entry["file"])
    mix = dict(_load(HERE / "mixes" / f"{w['traffic']}.json"), **(overrides or {}))
    extra = _load(HERE / "cells" / f"{workload}.json")
    fleet = Fleet.from_config(config)
    proto = config["protocol"]
    T, warm, meas, rate = steady_params(
        fleet, np.asarray(mix["class_shares"], np.float64), float(mix["offered_load"]),
        int(proto["warmup_horizons"]), int(proto["measure_horizons"]))
    return Cell(name=workload, chips=int(w["chips"]), config=config, mix=mix,
                scheduler=extra["scheduler"], fleet=fleet,
                rules=Rules(fleet, config["metric"]), T=T, warm=warm, meas=meas,
                rate=rate)
