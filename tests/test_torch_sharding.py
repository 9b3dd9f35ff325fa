"""The port's sharding rules, meshes and input shapes against the JAX
package's, on the CPU.

JAX's side runs on abstract meshes (``jax.sharding.AbstractMesh``) over
``jax.eval_shape`` trees: no devices, no ``XLA_FLAGS``. The port's side
builds its full-width trees on fake tensors (``FakeTensorMode``, no
allocation). Specs are compared leaf by leaf, by key path, exactly:

  * ``params_pspecs`` and ``state_pspecs`` for all ten architectures at
    full width, on the 16x16 and 2x16x16 production meshes, with and
    without ``fsdp``;
  * ``cache_pspecs`` at ``decode_32k`` and at ``long_500k`` (the SWA
    variant, ``shard_seq``), ``batch_pspec``, ``gp_stacked_pspecs`` and its
    ``ValueError``;
  * the divisibility fallback of ``tests/test_substrate.py:100`` (qwen2's
    14 heads on a 16-wide model axis);
  * ``input_specs`` for every architecture x shape, and the model-FLOP
    counts of ``launch.hlo_analysis`` (``active_param_count``,
    ``model_flops_train``/``_decode``, ``analytical_flops_recurrent``).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro import sharding as jsh
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.launch import hlo_analysis as jhlo
from repro.models import transformer as jtr
from repro.runtime import steps as jsteps
from repro.sharding import rules as jrules
from repro_torch import sharding as tsh
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get, input_specs, swa_variant
from repro_torch.launch import hlo_analysis as thlo
from repro_torch.launch.mesh import MeshSpec, make_host_mesh, make_production_mesh
from repro_torch.models import transformer as ttr
from repro_torch.runtime.steps import init_train_state

MESHES = {"16x16": False, "2x16x16": True}


def _jax_mesh(mesh: MeshSpec) -> AbstractMesh:
    return AbstractMesh(mesh.sizes, mesh.axis_names)


def _jax_specs(tree) -> dict:
    """path names -> spec (a tuple) of a JAX spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jrules._path_names(path): tuple(spec) for path, spec in flat}


def _port_specs(tree, path=()) -> dict:
    """path names -> spec of a port spec tree (a spec is a plain tuple)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_specs(sub, path + (key,)).items()}
    if hasattr(tree, "_fields"):
        return {k: v for f in tree._fields
                for k, v in _port_specs(getattr(tree, f), path + (f,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_specs(sub, path + (str(i),)).items()}
    return {path: tree}


@functools.cache
def _port_state(arch: str):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_train_state(torch.Generator().manual_seed(0), get(arch))


@functools.cache
def _jax_state(arch: str):
    return jax.eval_shape(functools.partial(jsteps.init_train_state, cfg=jreg.get(arch)),
                          jax.random.PRNGKey(0))


def _norm(spec: tuple) -> tuple:
    """A one-axis tuple entry as the axis name: the same layout, which
    jax 0.9's ``PartitionSpec`` writes that way (the port keeps the rules'
    tuple)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _assert_same(port: dict, ref: dict) -> None:
    assert set(port) == set(ref)
    diff = {k: (port[k], ref[k]) for k in ref if _norm(port[k]) != _norm(ref[k])}
    assert not diff, list(diff.items())[:5]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------


def test_production_and_host_meshes():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert (one.axis_names, one.sizes, one.size) == (("data", "model"), (16, 16), 256)
    assert (two.axis_names, two.sizes, two.size) == (("pod", "data", "model"), (2, 16, 16), 512)
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_host_mesh().shape == {"data": 1, "model": 1}  # no process group: one device


# --------------------------------------------------------------------------
# specs, leaf by leaf
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_and_params_pspecs_equal_jax(arch, mesh_name, fsdp):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    pstate, jstate = _port_state(arch), _jax_state(arch)
    jmesh = _jax_mesh(mesh)
    _assert_same(_port_specs(tsh.params_pspecs(pstate.params, mesh, fsdp)),
                 _jax_specs(jsh.params_pspecs(jstate.params, jmesh, fsdp)))
    _assert_same(_port_specs(tsh.state_pspecs(pstate, mesh, fsdp)),
                 _jax_specs(jsh.state_pspecs(jstate, jmesh, fsdp)))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_jax(arch, mesh_name, shape):
    import dataclasses

    import jax.numpy as jnp

    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    sh = INPUT_SHAPES[shape]
    pcfg, jcfg = get(arch), jreg.get(arch)
    if shape == "long_500k":
        pcfg, jcfg = swa_variant(pcfg), jreg.swa_variant(jcfg)
    pcfg, jcfg = dataclasses.replace(pcfg, remat=False), dataclasses.replace(jcfg, remat=False)
    pcache = ttr.init_cache(pcfg, sh.global_batch, sh.seq_len, torch.bfloat16, device="meta")
    jcache = jax.eval_shape(functools.partial(jtr.init_cache, jcfg, sh.global_batch, sh.seq_len,
                                              jnp.bfloat16))
    shard_seq = sh.global_batch == 1
    _assert_same(_port_specs(tsh.cache_pspecs(pcache, mesh, shard_seq=shard_seq)),
                 _jax_specs(jsh.cache_pspecs(jcache, _jax_mesh(mesh), shard_seq=shard_seq)))


@pytest.mark.parametrize("shardable", [True, False])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspec_equals_jax(mesh_name, shardable):
    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    assert _norm(tsh.batch_pspec(mesh, shardable)) == \
        _norm(tuple(jsh.batch_pspec(_jax_mesh(mesh), shardable)))
    assert tsh.data_axes(mesh) == jsh.data_axes(_jax_mesh(mesh))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_gp_stacked_pspecs_equal_jax_and_refuse_a_wrong_lead(mesh_name):
    import jax.numpy as jnp

    mesh = make_production_mesh(multi_pod=MESHES[mesh_name])
    P = mesh.size
    shapes = {"z": (P, 5, 2), "w": (P, 5, 5), "c": (P, 5), "routed": [(P, 64, 2)]}
    ptree = {k: ([torch.empty(s[0], device="meta")] if isinstance(s, list)
                 else torch.empty(s, device="meta")) for k, s in shapes.items()}
    jtree = {k: ([jax.ShapeDtypeStruct(s[0], jnp.float32)] if isinstance(s, list)
                 else jax.ShapeDtypeStruct(s, jnp.float32)) for k, s in shapes.items()}
    _assert_same(_port_specs(tsh.gp_stacked_pspecs(ptree, mesh)),
                 _jax_specs(jsh.gp_stacked_pspecs(jtree, _jax_mesh(mesh))))
    bad = {"z": torch.empty((P - 1, 5, 2), device="meta")}
    with pytest.raises(ValueError, match="leading partition axis"):
        tsh.gp_stacked_pspecs(bad, mesh)
    with pytest.raises(ValueError, match="leading partition axis"):
        jsh.gp_stacked_pspecs({"z": jax.ShapeDtypeStruct((P - 1, 5, 2), jnp.float32)},
                              _jax_mesh(mesh))


def test_sharding_rules_divisibility_fallback():
    """Mirror of ``tests/test_substrate.py:100``: 14 heads on a 16-wide
    model axis — the flattened head products shard, d_ff = 120 falls back
    to replicated, the padded vocab shards, norms replicate."""
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(name="q2ish", arch_type="dense", num_layers=2, d_model=112,
                      num_heads=14, num_kv_heads=2, d_ff=120, vocab_size=150,
                      dtype="float32")
    params = ttr.init_model_params(torch.Generator().manual_seed(0), cfg)
    specs = tsh.params_pspecs(params, MeshSpec(("data", "model"), (1, 16)))
    assert specs["stack"]["b0"]["mix"]["wq"] == (None, None, "model")
    assert specs["stack"]["b0"]["mix"]["wk"] == (None, None, "model")
    assert specs["stack"]["b0"]["mlp"]["w_gate"] == (None, None, None)
    assert params["embed"].shape[0] == 256
    assert specs["embed"] == ("model", None)
    assert specs["final_norm"] == ()


def test_to_placements_and_local_shape():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh(multi_pod=True)
    assert tsh.to_placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0),
                                                                          Shard(2)]
    assert tsh.to_placements((), mesh) == [Replicate()] * 3
    assert tsh.local_shape((256, 7, 32), (("pod", "data"), None, "model"), mesh) == (8, 7, 2)
    with pytest.raises(ValueError, match="mesh order"):
        tsh.to_placements((("data", "pod"),), mesh)


# --------------------------------------------------------------------------
# input shapes and model-FLOP counts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_model_flops_equal_jax(arch, shape):
    assert INPUT_SHAPES[shape] == tuple(jshapes.INPUT_SHAPES[shape])
    pcfg, jcfg = get(arch), jreg.get(arch)
    port = {k: (v.shape, str(v.dtype).removeprefix("torch.")) for k, v in
            input_specs(pcfg, shape).items()}
    ref = {k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in
           jshapes.input_specs(jcfg, shape).items()}
    assert port == ref
    sh = INPUT_SHAPES[shape]
    assert thlo.active_param_count(pcfg) == jhlo.active_param_count(jcfg)
    assert thlo.model_flops_train(pcfg, sh.seq_len, sh.global_batch) == \
        jhlo.model_flops_train(jcfg, sh.seq_len, sh.global_batch)
    assert thlo.model_flops_decode(pcfg, sh.global_batch) == \
        jhlo.model_flops_decode(jcfg, sh.global_batch)
    assert thlo.has_time_while_loops(pcfg) == jhlo.has_time_while_loops(jcfg)
    assert thlo.analytical_flops_recurrent(pcfg, sh.seq_len, sh.global_batch, sh.kind) == \
        jhlo.analytical_flops_recurrent(jcfg, sh.seq_len, sh.global_batch, sh.kind)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "qwen3_0_6b"])
def test_trace_mesh_folds_the_data_axes(arch):
    """The trace's 2-D mesh keeps every leaf's local shape: (pod, data)
    become one axis of 32, named together by every rule."""
    from repro_torch.launch.mesh import trace_mesh
    from repro_torch.sharding.rules import fold_spec, leaf_specs, map_specs

    two = make_production_mesh(multi_pod=True)
    flat = trace_mesh(two)
    assert flat.shape == {"data": 32, "model": 16} and flat.size == two.size
    assert trace_mesh(make_production_mesh()) == make_production_mesh()
    state = _port_state(arch)
    for fsdp in (False, True):
        specs = tsh.state_pspecs(state, two, fsdp)
        folded = map_specs(lambda s: fold_spec(s, two), specs)
        for spec, fspec in zip(leaf_specs(specs), leaf_specs(folded), strict=True):
            assert all(e in (None, "model", "data") or e == ("data", "model") for e in fspec)
            shape = (2 * 16 * 16 * 3,) * len(spec)
            assert tsh.local_shape(shape, spec, two) == tsh.local_shape(shape, fspec, flat)
    assert fold_spec((("pod", "data", "model"),), two) == (("data", "model"),)
    with pytest.raises(ValueError, match="splits the data axes"):
        fold_spec(("pod",), two)
