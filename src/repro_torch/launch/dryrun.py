"""Multi-pod dry run: run every (arch × shape × mesh) cell's placed step
once on the production meshes, without data (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell's sharded step for 256 or
512 placeholder devices and reads XLA's compiled program:
``memory_analysis`` for each device's argument, output and temp bytes,
``cost_analysis`` for its flops and bytes accessed, and the HLO text
for its collectives (``parse_collectives``). A cell is ``ok`` only if
that program builds.

The port runs the step instead (``lower_cell``, ``lower_step``): a
``"fake"`` process group of the mesh's size with this process as rank 0
(``step_trace.fake_group``), a real ``DeviceMesh`` of the production
shape, (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data",
"model"), and under a ``FakeTensorMode`` each rank's shards of the
weights, the AdamW state, the batch and the cache, made directly by the
placements ``place`` reports (``DTensor.from_local``: nothing global is
made). The placed step (``steps.jit_train_step``, ``jit_prefill_step``
or ``jit_serve_step``) then runs once: DTensor's sharding propagation
and every collective it issues, on tensors with no bytes.
``step_trace.StepTrace`` reads rank 0's local ops: the memory
(arguments, outputs, and temp = the peak of live bytes less the
arguments), the flops and bytes, the collectives by kind. A cell is
``ok`` when its placement is valid and the step ran.

``device="cuda"`` traces fake CUDA tensors, where the kernels' ops
(``repro_torch::cg_dispatch``, ``ssd_scan``, ``ssd_scan_bwd``) stand in
for their launches with their outputs and scratch; ``device="cpu"``
traces the plain paths, except the MoE dispatch: on fake tensors of
either device ``cg_dispatch`` takes its op, whose fake gives the outputs
(the plain version's block loop would run for hours at qwen3-moe's
size), so a CPU report counts none of the plain dispatch's ops or
memory. A torch built without CUDA cannot run fake CUDA tensors: there
pass ``--device cpu``. Nothing switches the device quietly; the report
says which was traced (``device``) and which of the port's ops ran as
fakes (``custom_ops``, with their counts).

``place`` (and ``place_cell``, ``--place-only``) is the placement check
alone: every tensor's spec, each device's bytes of each group,
``params_total``/``params_active``, ``ok`` when every sharded dimension
divides and no axis repeats. The serve step's choice between TP-only
and 2-D weights takes the card's weight budget,
``steps.H100_WEIGHT_BUDGET``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--device cpu] [--place-only] [--multi-pod] [--single-pod-only] [--remat full] [--out report.json]
"""
from __future__ import annotations

import argparse
import functools
import json
import time
import traceback

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch import configs, optim
from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.models import model_zoo as zoo
from repro_torch.models.layers import act_sharding

from . import sharding as shd
from . import steps
from .mesh import ShapeMesh, make_production_mesh, n_chips
from .step_trace import StepTrace, fake_group
from .steps import H100_WEIGHT_BUDGET

@functools.lru_cache(maxsize=None)
def _param_specs(cfg) -> dict:
    return zoo.param_specs(cfg)


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


def _inputs(cfg, shape: ShapeSpec) -> dict:
    """The cell's meta tensors by group: the weights, and the batch (train,
    prefill) or the cache and the tokens (decode); a prefill's cache is
    its output, placed as the step places it."""
    ins = zoo.input_specs(cfg, shape)
    out = {"params": _param_specs(cfg)}
    if "batch" in ins:
        out["batch"] = ins["batch"]
    if shape.kind == "prefill":
        out["cache"] = zoo.cache_spec(cfg, shape.global_batch, shape.seq_len)
    elif "cache" in ins:
        out["cache"] = ins["cache"]
    if shape.kind == "decode":
        out["tokens"] = {"tokens": ins["tokens"]}
    return out


def place(cfg, shape: ShapeSpec, mesh,
          budget_bytes: float = H100_WEIGHT_BUDGET) -> dict:
    """Place one cell of ``cfg`` on ``mesh`` (a ``ShapeMesh`` or a
    ``DeviceMesh``) in the modes the placed steps choose
    (``launch.steps``) and return the placement's report: ``param_mode``,
    ``pure_dp``, ``ok`` and each group's specs and bytes a device."""
    ins = _inputs(cfg, shape)
    pspecs = ins["params"]
    n_total = zoo.count_params_specs(pspecs)
    n_dev = n_chips(mesh)
    eff = cfg.pure_dp and shape.global_batch % n_dev == 0
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
    if "cache" in ins:
        groups["cache"] = _group(ins["cache"], shd.cache_specs(
            ins["cache"], mesh, pure_dp=eff), mesh)
    if "tokens" in ins:
        tok = ins["tokens"]["tokens"]
        groups["tokens"] = _group(ins["tokens"], {
            "tokens": shd.batch_specs(tok, mesh, pure_dp=eff)}, mesh)
    return {
        "n_devices": n_dev, "param_mode": mode, "pure_dp": eff,
        "ok": all(g["ok"] for g in groups.values()),
        "groups": groups,
        "params_total": n_total,
        "params_active": zoo.active_params(cfg, n_total),
    }


def place_cell(arch: str, shape_name: str, *, multi_pod: bool,
               budget_bytes: float = H100_WEIGHT_BUDGET) -> dict:
    """Place one cell on a production mesh (``place``) and return its
    report."""
    r = place(configs.get_config(arch), SHAPES[shape_name],
              make_production_mesh(multi_pod=multi_pod), budget_bytes)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", **r}


def _shard(meta, spec, mesh, device, dtype=None) -> DTensor:
    """Rank 0's shard of a tensor shaped as ``meta`` (in its dtype, or
    ``dtype``), laid out by ``spec``, as a DTensor (inside a
    ``FakeTensorMode``: no bytes)."""
    shape = tuple(meta.shape)
    local = torch.empty(shd.local_shape(shape, spec, mesh),
                        dtype=dtype or meta.dtype, device=device)
    return DTensor.from_local(local, mesh, shd.to_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _sharded_module(cfg, specs: dict, mesh, device) -> nn.Module:
    """The family's weights module, each parameter rank 0's shard."""
    model = zoo._WEIGHTS[cfg.family](cfg, device="meta")
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(_shard(p, specs[name], mesh, device),
                                        requires_grad=False))
    return model


def _run_fake(cfg, shape_spec: ShapeSpec, mesh, specs: dict, dev):
    """Inside a ``FakeTensorMode``: rank 0's shards of the step's inputs,
    laid out by ``specs`` (group → name → spec), and the placed step run
    once under a ``StepTrace``; the trace and the outputs' bytes."""
    ins = _inputs(cfg, shape_spec)
    model = _sharded_module(cfg, specs["params"], mesh, dev)

    def tree(group):
        return {k: _shard(x, specs[group][k], mesh, dev)
                for k, x in ins[group].items()}
    if shape_spec.kind == "train":
        state = {part: {k: _shard(p, specs["opt"][f"{part}.{k}"], mesh, dev,
                                  torch.float32)
                        for k, p in ins["params"].items()}
                 for part in ("m", "v", "master")}
        state["step"] = _shard(torch.empty((), dtype=torch.int32,
                                           device="meta"), (), mesh, dev)
        batch = tree("batch")
        run = steps.jit_train_step(cfg, mesh)[0](batch)
        args = (model, state, batch)
    elif shape_spec.kind == "prefill":
        batch = tree("batch")
        run = steps.jit_prefill_step(cfg, mesh)[0](batch)
        args = (model, batch)
    else:
        cache, tokens = tree("cache"), tree("tokens")["tokens"]
        run = steps.jit_serve_step(cfg, mesh)[0](cache, tokens)
        args = (model, cache, tokens)
    trace = StepTrace()
    trace.track_args((list(model.parameters()), args[1:]))
    with trace:
        out = run(*args)
    if shape_spec.kind == "train":
        out = (list(out[0].parameters()), out[1:])
    return trace, trace.resident(out)


def lower_step(cfg, shape_spec: ShapeSpec, mesh_shape, axis_names, *,
               device: str = "cuda", remat: str | None = None) -> dict:
    """Run the placed step of one cell of ``cfg`` once, on a ``"fake"``
    group of the mesh's size, on fake tensors of ``device``; return the
    reference's report keys (module docstring) beside ``place``'s.
    Raises where the placement is invalid or the step fails."""
    if remat:
        cfg = cfg.replace(remat=remat)
    dev = torch.device(device)
    rep = place(cfg, shape_spec, ShapeMesh(mesh_shape, axis_names))
    if not rep["ok"]:
        raise ValueError(f"placement not valid: {rep['groups']}")
    n = rep["n_devices"]
    specs = {k: {name: tuple(s) for name, s in g["specs"].items()}
             for k, g in rep["groups"].items()}
    t0 = time.perf_counter()
    with fake_group(n), act_sharding({}):
        # the mesh reads its ranks from real tensors
        mesh = init_device_mesh(dev.type, tuple(mesh_shape),
                                mesh_dim_names=tuple(axis_names))
        with FakeTensorMode(allow_non_fake_inputs=True):
            trace, outputs = _run_fake(cfg, shape_spec, mesh, specs, dev)
    lower_s = time.perf_counter() - t0
    return {
        **rep, "ok": True, "device": dev.type, "remat": cfg.remat,
        "lower_s": lower_s,
        "memory": {"argument_size_in_bytes": trace.args,
                   "output_size_in_bytes": outputs,
                   "temp_size_in_bytes": trace.peak - trace.args},
        "flops_per_device": trace.flops,
        "bytes_per_device": trace.bytes,
        "collectives": trace.collectives(),
        "custom_ops": dict(trace.custom_ops),
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               remat: str | None = None, device: str = "cuda") -> dict:
    """Run one cell's placed step on a production mesh (``lower_step``)
    and return its report."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    r = lower_step(configs.get_config(arch), SHAPES[shape_name],
                   tuple(mesh.shape.values()), mesh.axis_names,
                   device=device, remat=remat)
    return {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", **r}


def summary(r: dict) -> str:
    """One line of a lowered cell's report."""
    coll = r["collectives"]
    by_kind = " ".join(f"{k}={v / 2**20:.1f}"
                       for k, v in sorted(coll["bytes_by_kind"].items()))
    return (f"{r['device']} {r['param_mode']} {r['lower_s']:.1f}s "
            f"temp/dev={r['memory']['temp_size_in_bytes'] / 2**30:.3f}GiB "
            f"args/dev={r['memory']['argument_size_in_bytes'] / 2**30:.3f}"
            f"GiB flops/dev={r['flops_per_device']:.4g} "
            f"coll={coll['total_bytes'] / 2**20:.1f}MiB ({by_kind})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default=None,
                    help="the configs' remat policy for every cell "
                         "(none, full, dots, attn_out)")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (the kernels' "
                         "ops' fakes) or cpu (the plain paths, but the "
                         "MoE dispatch's op fake)")
    ap.add_argument("--place-only", action="store_true",
                    help="check the placement alone, without the step")
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
                if args.place_only:
                    r = place_cell(arch, shape, multi_pod=mp)
                    line = f"{r['param_mode']} " + " ".join(
                        f"{k}/dev={g['bytes_per_device'] / 2**30:.3f}GiB"
                        for k, g in r["groups"].items())
                else:
                    r = lower_cell(arch, shape, multi_pod=mp,
                                   remat=args.remat, device=args.device)
                    line = summary(r)
                print(f"[{'OK' if r['ok'] else 'FAIL'}] {tag}: {line}",
                      flush=True)
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
