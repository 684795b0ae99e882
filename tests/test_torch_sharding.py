"""The port's placement rules against the JAX reference's, exactly: every
weight of every architecture at full size in the three modes, the
batch, cache and activation rules, the optimizer state's specs,
``spec_if_divisible`` and ``infer_mode_fits``, on meshes (1, 1), (2, 2),
(16, 16) and (2, 16, 16).

The reference's rules are pure functions of a mesh's shape, so they run
on a ``jax.sharding.AbstractMesh`` (no devices) over the reference's
``eval_shape`` trees; the port's on its shape-only ``ShapeMesh`` over its
meta tensors. The port's weights are per layer where the reference
stacks them on one leading dimension (zamba2's mamba layers on two): a
port spec must equal the reference's with those dimensions dropped, and
the dropped entries must be ``None``. Specs compare with trailing
``None``s stripped (``P()`` is the spec of no sharded dimension).
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro import optim as joptim
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import sharding as jshd
from repro.models import model_zoo as jzoo
from repro_torch import configs, optim
from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import model_zoo as zoo

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
MODES = ("train", "infer", "replicate")


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), ShapeMesh(shape, axes)


def norm(spec) -> tuple:
    """A spec as a tuple without trailing ``None``s, an entry of one axis
    as its name (``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    spec = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _key(k) -> str:
    return getattr(k, "key", getattr(k, "name", None))


def flat(tree) -> dict:
    """path (a tuple of names) → leaf of a reference tree of specs or
    shapes."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(_key(k) for k in path): leaf for path, leaf in leaves}


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return jzoo.param_specs(jconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return zoo.param_specs(configs.get_config(arch))


def ref_path(name: str) -> tuple[tuple, int]:
    """A port weight's reference path and its stacked dimensions."""
    parts = name.split(".")
    words = tuple(p for p in parts if not p.isdigit())
    return words, len(parts) - len(words)


def assert_port_specs_match(ref_tree_specs, port_specs: dict):
    """Every port weight's spec is its reference leaf's without the
    stacked dimensions; every reference leaf is covered."""
    ref = flat(ref_tree_specs)
    seen = set()
    for name, spec in port_specs.items():
        path, stacked = ref_path(name)
        want = tuple(ref[path]) + (None,) * (len(spec) + stacked
                                             - len(ref[path]))
        assert want[:stacked] == (None,) * stacked, (name, want)
        assert norm(spec) == norm(want[stacked:]), (name, spec, want)
        seen.add(path)
    assert seen == set(ref), set(ref) ^ seen


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_match_the_references(arch, mode, mesh_name):
    jmesh, tmesh = meshes(mesh_name)
    ref = jshd.param_specs_tree(ref_params(arch), jmesh, mode)
    port = shd.param_specs_tree(port_params(arch), tmesh, mode)
    assert_port_specs_match(ref, port)
    shapes = {n: tuple(p.shape) for n, p in port_params(arch).items()}
    for name, spec in port.items():
        assert shd.spec_is_valid(spec, shapes[name], tmesh), (name, spec)
    # the optimizer state mirrors the weights; the step replicates
    ref_o = joptim.init_specs(ref, P())
    port_o = optim.init_specs(port, ())
    for part in ("m", "v", "master"):
        assert_port_specs_match(ref_o[part], port_o[part])
    assert norm(ref_o["step"]) == norm(port_o["step"]) == ()


def _inputs(arch):
    """(shape name, reference input specs, port input specs) of every
    applicable cell of ``arch``."""
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    return [(s, jzoo.input_specs(jcfg, JSHAPES[s]),
             zoo.input_specs(cfg, SHAPES[s]))
            for a, s, ok in configs.cells() if a == arch and ok]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_batch_and_cache_specs_match_the_references(arch, mesh_name):
    jmesh, tmesh = meshes(mesh_name)
    cells = _inputs(arch)
    assert cells
    for shape, ref_in, port_in in cells:
        for pure_dp in (False, True):
            if "batch" in port_in:
                ref = jshd.batch_specs(ref_in["batch"], jmesh, pure_dp)
                port = shd.batch_specs(port_in["batch"], tmesh, pure_dp)
                assert set(ref) == set(port)
                for k in ref:
                    assert norm(port[k]) == norm(ref[k]), (shape, k)
            else:
                ref = jshd.cache_specs(ref_in["cache"], jmesh, pure_dp)
                port = shd.cache_specs(port_in["cache"], tmesh, pure_dp)
                assert set(ref) == set(port)
                for k in ref:
                    assert norm(port[k]) == norm(ref[k]), (shape, k)
                tok = shd.batch_specs(port_in["tokens"], tmesh, pure_dp)
                assert norm(tok) == norm(jshd.batch_specs(
                    ref_in["tokens"], jmesh, pure_dp))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_act_rules_and_scalars_match_the_references(mesh_name):
    jmesh, tmesh = meshes(mesh_name)
    for pure_dp in (False, True):
        ref = jshd.act_rules(jmesh, pure_dp)
        port = shd.act_rules(tmesh, pure_dp)
        assert set(ref) == set(port)
        for k in ref:
            assert norm(port[k]) == norm(ref[k]), k
    assert shd.scalar_sharding(tmesh).placements == (
        (shd.Replicate(),) * len(MESHES[mesh_name][0]))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_if_divisible_matches_the_reference(mesh_name):
    jmesh, tmesh = meshes(mesh_name)
    axes = MESHES[mesh_name][1]
    choices = [None, *axes, tuple(axes[:2]), ("data", "model")]
    rng = np.random.default_rng(7)
    for _ in range(200):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice(
            [1, 2, 3, 4, 16, 32, 48, 256, 512, 1000], nd))
        wanted = [choices[i] for i in rng.integers(0, len(choices), nd)]
        assert norm(shd.spec_if_divisible(shape, tmesh, wanted)) == norm(
            jshd.spec_if_divisible(shape, jmesh, wanted)), (shape, wanted)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_infer_mode_fits_matches_the_reference(mesh_name):
    """With the same budget (the reference's default, passed explicitly
    to both) and each package's own parameter count."""
    jmesh, tmesh = meshes(mesh_name)
    for arch in configs.ARCH_IDS:
        n_ref = jzoo.count_params(ref_params(arch))
        n_port = zoo.count_params_specs(port_params(arch))
        assert n_ref == n_port, arch
        assert shd.infer_mode_fits(n_port, tmesh, 8e9) == \
            jshd.infer_mode_fits(n_ref, jmesh, 8e9), arch


def test_placements_of_specs():
    """A spec's placements on a mesh: ``Shard(d)`` per axis that shards
    dimension d, both mesh dimensions of a two-axis entry, and
    ``Replicate()`` on an axis of one device."""
    from torch.distributed.tensor import Replicate, Shard
    m = make_production_mesh(multi_pod=True)
    assert shd.to_placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.to_placements((None, "data"), m) == (
        Replicate(), Shard(1), Replicate())
    assert shd.to_placements(("data", "model"), ShapeMesh(
        (1, 2), ("data", "model"))) == (Replicate(), Shard(1))
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert not shd.spec_is_valid(("model", "model"), (32, 32), m)
    assert not shd.spec_is_valid(("data",), (8,), m)
    assert shd.local_shape((64, 48), (("pod", "data"), "model"), m) == (2, 3)
    assert torch.Size(shd.local_shape((4,), (None,), m)) == (4,)
