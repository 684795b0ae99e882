"""Small cells for the CPU tests: the cells' files with their scale cut
to what a test run holds (fewer workers, sources and keys, shorter
slots), everything else as committed. ``paper-wp10.strict`` is not in
``BENCHMARK.json`` (its runs spread past the bound; PERF.md, Open
questions) but keeps its files, so the strict engine's reference and
check stay tested."""
from __future__ import annotations

import copy

from cgbench.harness.spec import Cell, cell_from_files, load_cell

SMALL = {
    "storm-tw24.hh": dict(n_workers=4, alpha=4, slot_len=2048, n_sources=4,
                          block_size=16),
    "storm-tw24.uniform": dict(n_workers=4, alpha=4, slot_len=2048,
                               n_sources=4, block_size=16),
    "paper-wp10.strict": dict(slot_len=1024),
}
# cells with files but no entry in BENCHMARK.json: (config, traffic)
UNLISTED = {"paper-wp10.strict": ("paper-wp10", "wp-table1")}


def small_cell(name: str, loop: str = "", **cg) -> Cell:
    """``name`` cut to a test's size; ``loop="open"`` drives it open loop
    (the general generator's other schedule, which no cell uses yet)."""
    cell = (cell_from_files(name, *UNLISTED[name]) if name in UNLISTED
            else load_cell(name))
    cell.config = copy.deepcopy(cell.config)
    cell.config["cg"].update(SMALL[name], **cg)
    n = cell.config["cg"]["n_workers"]
    cell.config["capacities"]["relative"] = \
        cell.config["capacities"]["relative"][:n]
    cell.traffic = copy.deepcopy(cell.traffic)
    if loop:
        cell.traffic["loop"] = loop
    cell.traffic["keys"]["n_keys"] = 5000
    if cell.traffic["loop"] == "closed":
        cell.traffic["max_rate_msgs_per_s"] = 2e5
    else:
        cell.traffic["rate_msgs_per_s"] = 2e4
    cell.workload = copy.deepcopy(cell.workload)
    return cell
