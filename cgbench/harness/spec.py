"""A cell as data: its configuration, traffic mix and workload files,
found by the names in ``BENCHMARK.json``, and the metrics that
``BENCHMARK.json`` lists for it.

Files: ``cgbench/configs/<config>.json``, ``cgbench/traffic/<traffic>.json``,
``cgbench/workloads/<cell>.json`` and a reader ``cgbench/metrics/<metric>.py``
for every metric.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# the CG configuration keys a configuration file gives, all of them
CG_KEYS = ("n_workers", "alpha", "eps", "theta_busy", "theta_idle",
           "slot_len", "max_moves_per_slot", "inner", "block_size",
           "n_sources", "sync_every", "capacity_weighted", "rate_decay",
           "fcfs_pairing", "adaptive_moves", "min_moves", "depth_decay",
           "hysteresis", "theta_margin", "dwell", "hh_scheme",
           "sketch_depth", "sketch_width", "hot_fraction", "d_heavy",
           "d_tail", "hh_headroom", "engine")


@dataclass
class Cell:
    name: str
    config: dict            # the configuration file
    traffic: dict           # the traffic mix file
    workload: dict          # the cell's own file: warm-up and check sizes
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    chips: int = 1

    @property
    def cg(self) -> dict:
        return self.config["cg"]

    @property
    def slot_len(self) -> int:
        return int(self.cg["slot_len"])


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def validate_config(config: dict) -> None:
    missing = [k for k in CG_KEYS if k not in config["cg"]]
    if missing:
        raise ValueError(f"configuration {config.get('name')!r} lacks "
                         f"CG keys {missing}")
    cg = config["cg"]
    if cg["n_sources"] > 1 and cg["slot_len"] % cg["n_sources"]:
        raise ValueError("slot_len must be a multiple of n_sources")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    entry = entries[name]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return cell_from_files(name, entry["config"], entry["traffic"],
                           root / "cgbench", e2e, per_layer,
                           int(entry["chips"]))


def cell_from_files(name: str, config: str, traffic: str,
                    bench_dir: Path = BENCH_DIR, end_to_end=(),
                    per_layer=(), chips: int = 1) -> Cell:
    """A cell from its configuration, traffic and workload files alone
    (``load_cell`` adds what ``BENCHMARK.json`` says of it)."""
    cfg = read_json(bench_dir / "configs" / f"{config}.json")
    validate_config(cfg)
    return Cell(name, cfg,
                read_json(bench_dir / "traffic" / f"{traffic}.json"),
                read_json(bench_dir / "workloads" / f"{name}.json"),
                list(end_to_end), list(per_layer), chips)


def capacities(config: dict):
    """The workers' service rates as float64 numbers: the relative speeds
    normalised to sum 1, over the provisioning point rho (one message
    arrives per unit time)."""
    rel = [float(x) for x in config["capacities"]["relative"]]
    rho = float(config["capacities"]["rho"])
    total = math.fsum(rel)
    return [x / total / rho for x in rel]
