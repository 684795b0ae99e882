#!/usr/bin/env python3
"""Run one benchmark cell once on one CUDA device.

    python3 cgbench/run.py --workload storm-tw24.hh --seed 7 --seconds 10 --trace 0

Set-up makes the cell's key stream on the device from ``--seed``, builds
or loads the port's kernels (``build/repro_torch_kernels/`` in the
checkout) and routes the warm-up slots. Then the window: ``--seconds`` of
slots through ``repro_torch.core.cg.run`` with the state carried, closed
or open loop as the traffic mix says. With ``--trace 1`` the first half
of the window is measured as with ``--trace 0`` (spans, counters) and the
second half under ``torch.profiler`` (device time, idle gaps). After the
window the plain reference checks the run (``harness/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit. The same numbers end standard error.

Exits 2 without a CUDA device, 3 if JAX or the JAX package (``repro``)
was loaded, 1 on any other failure, such as a window that outruns the
keys made for it (a configuration's ``exact_below_messages`` caps them);
none of these prints a result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from cgbench.harness import check, isolation, loops, traffic  # noqa: E402
from cgbench.harness import trace as tracemod  # noqa: E402
from cgbench.harness.record import Record  # noqa: E402
from cgbench.harness.spec import BENCH_DIR, Cell, load_cell  # noqa: E402


# iterations of the host probe's loop (some 10 ms on a current core)
HOST_PROBE_ITERS = 200_000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def reader(name: str):
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cgbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit_w() -> float | None:
    """The card's power limit in W by nvidia-smi, None where it cannot
    say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def log_windows(windows):
    """How steadily each window issued its slots, and for an open loop
    how late the generator ran, on standard error."""
    for w in windows:
        t = w.issued_s
        if len(t) > 1:
            gaps = sorted(((t[k + 1] - t[k], k) for k in range(len(t) - 1)),
                          reverse=True)[:3]
            per_s = [0] * (int(t[-1]) + 1)
            for x in t:
                per_s[int(x)] += 1
            log(f"{w.kind} window: slots issued each second {per_s}; longest "
                "gaps between issues (ms, after slot, at s): "
                + ", ".join(f"({1e3 * g:.2f}, {w.first_slot + k}, {t[k]:.2f})"
                            for g, k in gaps))
        if w.lateness_s:
            late = sorted(w.lateness_s)
            log(f"generator lateness over {len(late)} slots: median "
                f"{1e3 * late[len(late) // 2]:.4f} ms, p95 "
                f"{1e3 * late[int(0.95 * (len(late) - 1))]:.4f} ms, max "
                f"{1e3 * late[-1]:.4f} ms")


def host_probe_ms() -> float:
    """Milliseconds a fixed pure-Python loop takes, the median of three:
    the host's own speed, logged beside a host-bound rate."""
    times = []
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(HOST_PROBE_ITERS):
            x += i & 7
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[1]


def counter_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def measure(run, delivery, cell: Cell, seconds: float, device):
    if cell.traffic["loop"] == "closed":
        return loops.closed_loop(run, delivery, seconds, device)
    return loops.open_loop(run, delivery, seconds,
                           float(cell.traffic["rate_msgs_per_s"]),
                           cell.slot_len, device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             program=None, t_start: float | None = None) -> dict:
    """Set up, measure and check one run of ``cell``; the result as a
    dict (``checks`` last). ``program`` replaces the system under test
    (a check of the harness does so)."""
    from cgbench.harness.program import Program
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    marks = [("imports", time.perf_counter() - t_start)]
    program = Program(cell, device) if program is None else program
    warm = int(cell.workload["warm_slots"])
    n_slots = traffic.slots_needed(cell.traffic, cell.slot_len, seconds, warm)
    exact_below = cell.config.get("exact_below_messages")
    stream_note = ""
    if exact_below is not None and n_slots * cell.slot_len > exact_below:
        n_slots = int(exact_below) // cell.slot_len
        stream_note = (f"; {cell.config['name']} is exact only below "
                       f"{exact_below} routed messages (exact_below_messages:"
                       " the port's f32 load sums, PERF.md, Open questions)")
    keys = traffic.make_stream(cell.traffic, cell.slot_len, n_slots, seed,
                               device)
    loops.sync(device)
    marks.append(("stream", time.perf_counter() - t_start))
    spec = cell.workload["check"]
    run = loops.Run(program, keys, program.init_state(),
                    start_slots=warm + int(spec["start_slots"]),
                    sample_size=int(spec["sampled_slots"]), seed=seed,
                    stream_note=stream_note)
    delivery = loops.Delivery(cell.slot_len, device)
    loops.warm_up(run, delivery, 1, device)
    marks.append(("first slot", time.perf_counter() - t_start))
    loops.warm_up(run, delivery, warm - 1, device)
    if trace:
        # CUPTI starts up here, not in the window
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
            loops.sync(device)
    isolation.require_isolated("after set-up")
    setup_s = time.perf_counter() - t_start
    marks.append(("set-up", setup_s))
    log("set-up (s since start): " + ", ".join(f"{k} {v:.3f}"
                                               for k, v in marks)
        + f"; {n_slots} slots of keys made")

    # what set-up made is long-lived: keep the collector from rescanning it
    # in the window
    gc.collect()
    gc.freeze()
    probe = [host_probe_ms()]
    before = program.counters()
    first = run.next_slot
    window = measure(run, delivery, cell, seconds / 2 if trace else seconds,
                     device)
    launches = counter_delta(before, program.counters())
    moves = [int(x) for x in torch.stack(run.executed[first:]).tolist()] \
        if window.slots else []
    traced = tr = None
    if trace:
        with profile(activities=acts) as prof:
            traced = measure(run, delivery, cell, seconds / 2, device)
        tr = tracemod.read(prof)
        del prof
    cuda = device.type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    isolation.require_isolated("after the window")
    probe.append(host_probe_ms())
    log_windows([w for w in (window, traced) if w is not None])
    log(f"host probe (ms, before and after the window): {probe[0]:.3f}, "
        f"{probe[1]:.3f}")

    rec = Record(cell=cell, setup_s=setup_s, window=window,
                 launches=launches, moves=moves, traced=traced, trace=tr,
                 device_kind=torch.cuda.get_device_name(device) if cuda
                 else "", power_limit_w=power_limit_w() if cuda else None)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"])(rec)
        if v is None:
            continue
        entry = dict(v) if isinstance(v, dict) else dict(value=v)
        entry["unit"] = m["unit"]
        metrics[m["name"]] = entry

    # the correctness check, once the window has closed and the peak is read
    n_window = run.next_slot - first
    numbers, checked = check.check_run(cell, run, delivery, device)
    limits = spec["limits"]
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items())
    windows = [w for w in (window, traced) if w is not None]
    attempted = sum(w.slots + w.failed for w in windows)
    failed = sum(w.failed for w in windows)
    dev_info = dict(platform="gpu" if cuda else device.type,
                    kind=rec.device_kind, count=1,
                    memory_peak_bytes=int(memory_peak))
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=dev_info)
    if tr is not None:
        dev_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = dict(device_ops=tr.device_ops,
                                idle_gaps=tr.idle_gaps)
    log(f"cell {cell.name} seed {seed}: {n_window} slots in the window; "
        f"checked {checked['start_slots']} slots from the start and "
        f"window slots {checked['sampled_slots']} "
        f"({checked['messages']} messages); power limit "
        f"{rec.power_limit_w} W")
    for i, k, s, at, again in checked["mismatched_slots"]:
        log(f"slot {i} differs from the reference: {k} VWs (the first at "
            f"message {at}), {s} state entries; the program run again "
            f"from the same state differs from its first answer in {again} "
            "VWs")
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"cgbench: {cell.name} needs {cell.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    # one process, one host thread of tensor work: the program's host
    # ops are small, and idle worker threads only compete for the cores
    torch.set_num_threads(1)
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       device, t_start=T_START)
    except isolation.IsolationError as e:
        log(f"cgbench: {e}")
        return 3
    except loops.StreamExhausted as e:
        log(f"cgbench: {e}")
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
