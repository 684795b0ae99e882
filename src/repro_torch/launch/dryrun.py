"""Multi-pod dry run: place every (arch × shape × mesh) cell on the
production meshes and check the layout (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's sharded step for 512
placeholder CPU devices standing in for two TPU pods, then reads XLA's
compiled program: ``memory_analysis`` for the per-device memory and the
HLO text for the collectives (``parse_collectives``). The port compiles
no program, so both are left out. What it checks instead needs no
device: the weights (``zoo.param_specs``) and the inputs
(``zoo.input_specs``) are meta tensors, laid out by ``launch.sharding``'s
rules on the shape-only (16, 16) and (2, 16, 16) meshes
(``make_production_mesh``), and for every applicable cell it reports

  * the spec of every weight, optimizer-state, batch and cache tensor,
    in the modes the placed steps choose (``launch.steps``);
  * each device's bytes of each of those groups, from the local shard
    shapes;
  * ``params_total`` and ``params_active``;
  * ``ok``: every sharded dimension divides by its axes and no tensor
    uses a mesh axis twice.

The serve step's choice between TP-only and 2-D weights takes the
card's weight budget, ``steps.H100_WEIGHT_BUDGET``. The port counts
its collectives on a real mesh instead (``CommDebugMode``: the tests
and ``chip_smoke.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod-only] [--out report.json]
"""
from __future__ import annotations

import argparse
import functools
import json
import traceback

import torch

from repro_torch import configs, optim
from repro_torch.configs.base import SHAPES
from repro_torch.models import model_zoo as zoo

from . import sharding as shd
from .mesh import make_production_mesh
from .steps import H100_WEIGHT_BUDGET


@functools.lru_cache(maxsize=None)
def _param_specs(arch: str) -> dict:
    return zoo.param_specs(configs.get_config(arch))


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _group(tensors: dict, specs: dict, mesh) -> dict:
    """name → spec of a group of meta tensors, each device's bytes of
    the group, and whether every spec is valid."""
    per_dev, ok = 0, True
    for name, t in tensors.items():
        spec = specs[name]
        ok &= shd.spec_is_valid(spec, tuple(t.shape), mesh)
        per_dev += _nbytes(shd.local_shape(tuple(t.shape), spec, mesh),
                           t.dtype)
    return dict(specs={n: list(s) for n, s in specs.items()},
                bytes_per_device=per_dev, ok=bool(ok))


def place_cell(arch: str, shape_name: str, *, multi_pod: bool,
               budget_bytes: float = H100_WEIGHT_BUDGET) -> dict:
    """Place one cell (the placed step's modes, as ``launch.steps``
    chooses them) and return its report."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    pspecs = _param_specs(arch)
    n_total = zoo.count_params_specs(pspecs)
    eff = cfg.pure_dp and shape.global_batch % mesh.size == 0
    ins = zoo.input_specs(cfg, shape)
    if eff:
        mode = "replicate"
    elif shape.kind == "decode":
        mode = ("infer" if shd.infer_mode_fits(n_total, mesh, budget_bytes)
                else "train")
    else:
        mode = "train"
    p_specs = shd.param_specs_tree(pspecs, mesh, mode)
    groups = {"params": _group(pspecs, p_specs, mesh)}
    if shape.kind == "train":
        o = optim.init_specs(p_specs, ())
        f32 = {n: torch.empty(p.shape, dtype=torch.float32, device="meta")
               for n, p in pspecs.items()}
        opt = {f"{part}.{n}": t for part in ("m", "v", "master")
               for n, t in f32.items()}
        groups["opt"] = _group(opt, {f"{part}.{n}": o[part][n]
                                     for part in ("m", "v", "master")
                                     for n in f32}, mesh)
    if "batch" in ins:
        groups["batch"] = _group(ins["batch"], shd.batch_specs(
            ins["batch"], mesh, pure_dp=eff), mesh)
    if shape.kind == "prefill":
        cache = zoo.cache_spec(cfg, shape.global_batch, shape.seq_len)
    else:
        cache = ins.get("cache")
    if cache is not None:
        groups["cache"] = _group(cache, shd.cache_specs(cache, mesh,
                                                        pure_dp=eff), mesh)
    if shape.kind == "decode":
        tok = ins["tokens"]
        groups["tokens"] = _group({"tokens": tok}, {
            "tokens": shd.batch_specs(tok, mesh, pure_dp=eff)}, mesh)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size, "param_mode": mode, "pure_dp": eff,
        "ok": all(g["ok"] for g in groups.values()),
        "groups": groups,
        "params_total": n_total,
        "params_active": zoo.active_params(cfg, n_total),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default=None,
                    help="accepted as the reference's dry run accepts it; "
                         "no placement depends on it, so it has no effect")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a, s, applicable in configs.cells() if applicable]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True]
    if args.multi_pod:
        meshes = [True]
    if args.single_pod_only:
        meshes = [False]

    reports = []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} × {shape} × {'2x16x16' if mp else '16x16'}"
            try:
                r = place_cell(arch, shape, multi_pod=mp)
                per = {k: g["bytes_per_device"] / 2**30
                       for k, g in r["groups"].items()}
                print(f"[{'OK' if r['ok'] else 'FAIL'}] {tag}: "
                      f"{r['param_mode']} "
                      + " ".join(f"{k}/dev={v:.3f}GiB"
                                 for k, v in per.items()), flush=True)
            except Exception as e:  # noqa: BLE001 (a cell's failure is reported)
                r = {"arch": arch, "shape": shape,
                     "mesh": "2x16x16" if mp else "16x16",
                     "ok": False, "error": f"{type(e).__name__}: {e}",
                     "trace": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}",
                      flush=True)
            reports.append(r)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1, default=str)
        print(f"wrote {args.out}")
    n_ok = sum(1 for r in reports if r.get("ok"))
    print(f"{n_ok}/{len(reports)} cells OK")
    return 0 if n_ok == len(reports) else 1


if __name__ == "__main__":
    raise SystemExit(main())
