"""The port's sharding layer (``dist/shardings.py``, ``launch/mesh.py``)
against the JAX package's, in one process.

Plans are built on abstract meshes (JAX's ``AbstractMesh`` and the port's),
so the production 16x16 and 2x16x16 grids need no ranks. For every
registry architecture on both grids the port's ``init_param_specs`` is
JAX's spec for spec (a spec compares as the tuple of its entries) and
``make_plan``'s fields are JAX's; the cases of ``tests/test_shardings.py``
run on the port; every ``ShardingError`` the port raises is JAX's, with
JAX's text; ``placements`` maps specs onto a 2x2 mesh's DTensor
placements.
"""
import dataclasses

import pytest
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs.registry import ARCHS
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke as jget_smoke
from repro.dist import shardings as jsh
from repro.launch.mesh import make_plan as jmake_plan
from repro.models.model import init_param_specs as jinit_param_specs
from repro.models.model import param_shapes as jparam_shapes
from repro_torch.configs import get_config, get_smoke
from repro_torch.dist import shardings as sh
from repro_torch.dist.shardings import (P, ShardingError, ShardingPlan,
                                        placements, spec_for_param,
                                        validate_spec_tree)
from repro_torch.launch.mesh import (MODEL_AXIS, PRODUCTION_SHAPES,
                                     AbstractMesh, make_plan,
                                     make_production_mesh)
from repro_torch.models.model import init_param_specs, param_shapes

GRIDS = {"16x16": ((16, 16), ("data", "model")),
         "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PLAN_FIELDS = ("dp_axes", "model_axis", "model_size", "fsdp_axes",
               "seq_parallel", "context_parallel", "dp_size", "moe_ep",
               "axis_sizes")


def meshes(grid):
    """(JAX's AbstractMesh, the port's) of one grid."""
    sizes, names = GRIDS[grid] if isinstance(grid, str) else grid
    return JAbstractMesh(tuple(sizes), tuple(names)), \
        AbstractMesh(sizes, names)


def walk(shapes, specs, prefix=""):
    assert isinstance(specs, dict) == isinstance(shapes, dict), prefix
    if isinstance(shapes, dict):
        assert set(specs) == set(shapes), (prefix, set(specs) ^ set(shapes))
        for k in shapes:
            yield from walk(shapes[k], specs[k],
                            f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tuple(shapes), specs


def same_spec(got, want):
    """Entry by entry: the port's spec is a tuple, JAX's compares equal to
    one."""
    return isinstance(got, P) and tuple(got) == tuple(want) and want == got


def plan_fields(plan):
    return {f: (dict(getattr(plan, f)) if f == "axis_sizes"
                else getattr(plan, f)) for f in PLAN_FIELDS}


@pytest.mark.parametrize("moe_ep", [False, True], ids=["gspmd", "moe_ep"])
@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch, grid, moe_ep):
    jmesh, mesh = meshes(grid)
    jplan = jmake_plan(jget_config(arch), mesh=jmesh, moe_ep=moe_ep)
    cfg = get_config(arch)
    plan = make_plan(cfg, mesh=mesh, moe_ep=moe_ep)
    assert plan_fields(plan) == plan_fields(jplan)
    shapes = param_shapes(cfg)
    assert shapes == jparam_shapes(jget_config(arch))
    want = {path: spec for path, _, spec in walk(
        shapes, jinit_param_specs(jget_config(arch), jplan))}
    sizes = dict(jmesh.shape)
    n_sharded = 0
    for path, shape, spec in walk(shapes, init_param_specs(cfg, plan)):
        assert same_spec(spec, want[path]), (path, spec, want[path])
        # tests/test_shardings.py's checks, on the port's spec
        used = []
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            total = 1
            for ax in axes:
                assert ax in sizes and ax not in used, (path, spec)
                used.append(ax)
                total *= sizes[ax]
            assert shape[d] % total == 0, (path, shape, spec)
            n_sharded += 1
        if path.startswith("blocks/"):
            assert spec[0] is None, (path, spec)
        assert "pod" not in used, (path, spec)
    assert n_sharded > 0
    validate_spec_tree(init_param_specs(cfg, plan), shapes, plan)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_weight_matrix_is_sharded(arch):
    cfg = get_config(arch)
    plan = make_plan(cfg, mesh=meshes("16x16")[1])
    for path, shape, spec in walk(param_shapes(cfg),
                                  init_param_specs(cfg, plan)):
        base = shape[1:] if path.startswith("blocks/") else shape
        if len(base) >= 2:
            assert any(e is not None for e in spec), (path, shape, spec)


def test_smoke_configs_shard_on_small_mesh():
    jmesh, mesh = meshes(((2, 2), ("data", "model")))
    for arch in ARCHS:
        cfg = get_smoke(arch)
        plan = make_plan(cfg, mesh=mesh)
        specs = init_param_specs(cfg, plan)
        validate_spec_tree(specs, param_shapes(cfg), plan)
        want = {path: spec for path, _, spec in walk(
            jparam_shapes(jget_smoke(arch)), jinit_param_specs(
                jget_smoke(arch), jmake_plan(jget_smoke(arch), mesh=jmesh)))}
        for path, _, spec in walk(param_shapes(cfg), specs):
            assert same_spec(spec, want[path]), (arch, path, spec)


def test_plan_derived_from_mesh_shape():
    cfg = get_config("granite-3-2b")
    plan = make_plan(cfg, mesh=AbstractMesh((4, 2), ("data", "model")))
    assert plan.dp_size == 4 and plan.model_size == 2
    assert plan.dp_axes == ("data",) and plan.fsdp_axes == ("data",)
    plan3 = make_plan(cfg, mesh=AbstractMesh((3, 4, 2),
                                             ("pod", "data", "model")))
    assert plan3.dp_size == 12 and plan3.dp_axes == ("pod", "data")
    assert plan3.fsdp_axes == ("data",)
    assert plan3.dp() == ("pod", "data")
    assert make_plan(cfg).dp_size == 16
    assert make_plan(cfg, multi_pod=True).dp_size == 32
    assert plan_fields(make_plan(cfg, multi_pod=True)) == \
        plan_fields(jmake_plan(jget_config("granite-3-2b"), multi_pod=True))
    assert PRODUCTION_SHAPES[True] == ((2, 16, 16),
                                       ("pod", "data", MODEL_AXIS))
    with pytest.raises(ValueError, match="model"):
        make_plan(cfg, mesh=AbstractMesh((4, 2), ("a", "b")))


def test_context_parallel_cache_layout():
    cfg = get_config("mamba2-2.7b")
    mesh = meshes("16x16")[1]
    plan = make_plan(cfg, shape_kind="decode", batch=1, mesh=mesh)
    assert plan.context_parallel
    assert plan.cache_spec("kv", dict(kvh=8, hd=128)) == \
        (None, "data", None, "model")
    assert plan.cache_spec("ssm", dict(h=80)) == (None, "model", None, None)
    assert plan.act_spec() == P(None, None, None)
    assert plan.logits_spec() == P(None, None, "model")
    plan = make_plan(cfg, shape_kind="decode", batch=128, mesh=mesh)
    assert not plan.context_parallel
    assert plan.cache_spec("kv", dict(kvh=8, hd=128)) == \
        ("data", None, None, "model")
    assert plan.cache_spec("kv", dict(kvh=16, hd=128)) == \
        ("data", None, "model", None)
    assert plan.cache_spec("kv_flat", dict(x=512)) == ("data", None, "model")
    assert plan.cache_spec("conv", dict(c=5376)) == ("data", None, "model")
    assert plan.act_spec() == P("data", None, None)
    seq = make_plan(cfg, mesh=mesh, seq_parallel=True)
    assert seq.act_spec() == P("data", "model", None)
    # every kind on both packages' plans
    jplan = jmake_plan(jget_config("mamba2-2.7b"), shape_kind="decode",
                       batch=1, mesh=meshes("16x16")[0])
    plan = make_plan(cfg, shape_kind="decode", batch=1, mesh=mesh)
    for kind, dims in (("kv", dict(kvh=2, hd=64)), ("kv_flat", dict(x=48)),
                       ("ssm", dict(h=8)), ("conv", dict(c=20))):
        assert plan.cache_spec(kind, dims) == jplan.cache_spec(kind, dims)
    for name in ("act_spec", "logits_spec", "ep_spec"):
        assert same_spec(getattr(plan, name)(), getattr(jplan, name)())


def test_moe_ep_regroups_expert_weights():
    cfg = get_config("qwen2-moe-a2.7b")
    mesh = meshes("16x16")[1]
    plan = make_plan(cfg, mesh=mesh)
    ep = make_plan(cfg, mesh=mesh, moe_ep=True)
    shp = (1, 64, cfg.d_model, cfg.d_ff)
    assert spec_for_param("blocks/pos0/we_g", shp, cfg, plan) == \
        P(None, "model", None, "data")
    assert spec_for_param("blocks/pos0/we_g", shp, cfg, ep) == \
        P(None, "model", None, None)
    assert spec_for_param("blocks/pos0/we_2", (1, 64, cfg.d_ff, cfg.d_model),
                          cfg, ep) == P(None, "model", None, None)
    assert ep.ep_spec() == P("model", None, None)
    assert sh.MOE_EXPERT_PARAMS == ("we_g", "we_1", "we_2")


def test_serving_layout_drops_fsdp():
    cfg = get_config("qwen2-72b")
    plan = dataclasses.replace(make_plan(cfg, mesh=meshes("16x16")[1]),
                               fsdp_axes=())
    assert spec_for_param("blocks/pos0/wq", (1, 8192, 8192), cfg, plan) == \
        P(None, None, "model")
    assert spec_for_param("blocks/pos0/ln1", (1, 8192), cfg, plan) == \
        P(None, None)


def _port_jax(fn):
    """``fn(package view)`` on the port and on JAX: (port's error, JAX's).
    The view has the package's plan maker, spec functions and P on the
    16x16 grid with qwen2-72b."""
    out = []
    for pkg in ("port", "jax"):
        jm, m = meshes("16x16")
        mod = sh if pkg == "port" else jsh
        view = dict(
            plan=(make_plan(get_config("qwen2-72b"), mesh=m) if pkg == "port"
                  else jmake_plan(jget_config("qwen2-72b"), mesh=jm)),
            cfg=get_config("qwen2-72b") if pkg == "port"
            else jget_config("qwen2-72b"),
            P=P if pkg == "port" else JP, sh=mod)
        with pytest.raises((ShardingError, jsh.ShardingError, ValueError)) \
                as err:
            fn(view)
        out.append(err.value)
    return out


ERROR_CASES = {
    "no_rule_block": lambda v: v["sh"].spec_for_param(
        "blocks/pos0/mystery_w", (4, 16, 16), v["cfg"], v["plan"]),
    "no_rule_top": lambda v: v["sh"].spec_for_param(
        "mystery_top", (16, 16), v["cfg"], v["plan"]),
    "indivisible_param": lambda v: v["sh"].spec_for_param(
        "blocks/pos0/wq", (1, 8192, 100), v["cfg"], v["plan"]),
    "indivisible_fsdp": lambda v: v["sh"].spec_for_param(
        "blocks/pos0/wq", (1, 100, 8192), v["cfg"], v["plan"]),
    "family_rank": lambda v: v["sh"].spec_for_param(
        "blocks/pos0/wq", (1, 8192), v["cfg"], v["plan"]),
    "indivisible_spec": lambda v: v["sh"].validate_spec(
        v["P"]("model"), (100,), v["plan"], "x"),
    "unknown_axis": lambda v: v["sh"].validate_spec(
        v["P"]("bogus_axis"), (16,), v["plan"], "x"),
    "axis_twice": lambda v: v["sh"].validate_spec(
        v["P"]("model", "model"), (16, 16), v["plan"], "x"),
    "more_entries": lambda v: v["sh"].validate_spec(
        v["P"](None, None), (16,), v["plan"], "x"),
    "bad_entry": lambda v: v["sh"].validate_spec(
        v["P"](3), (16,), v["plan"], "x"),
    "tree_mismatch": lambda v: v["sh"].validate_spec_tree(
        {"a": v["P"]()}, (16,), v["plan"]),
    "key_mismatch": lambda v: v["sh"].validate_spec_tree(
        {"a": v["P"]()}, {"b": (16,)}, v["plan"]),
    "cache_kind": lambda v: v["plan"].cache_spec("bogus", {}),
    "fsdp_not_dp": lambda v: dataclasses.replace(
        v["plan"], fsdp_axes=("model",)),
    "model_in_dp": lambda v: dataclasses.replace(
        v["plan"], dp_axes=("data", "model"), fsdp_axes=()),
    "model_size": lambda v: dataclasses.replace(v["plan"], model_size=8),
    "dp_size": lambda v: dataclasses.replace(v["plan"], dp_size=8),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_sharding_errors_match_jax(case):
    got, want = _port_jax(ERROR_CASES[case])
    assert type(got).__name__ == type(want).__name__
    assert str(got) == str(want)


def test_plan_without_a_model_axis_raises_as_jax():
    for pkg_plan, m in ((make_plan, AbstractMesh((4, 2), ("a", "b"))),
                        (jmake_plan, JAbstractMesh((4, 2), ("a", "b")))):
        with pytest.raises(ValueError, match="'model' axis"):
            pkg_plan(get_config("granite-3-2b"), mesh=m)


def test_production_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="need 256 devices"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")


def test_placements_on_a_2x2_mesh():
    mesh = AbstractMesh((2, 2), ("data", "model"))
    assert placements(P("data", "model"), mesh) == (Shard(0), Shard(1))
    assert placements(P(None, "model", None, None), mesh) == \
        (Replicate(), Shard(1))
    assert placements(P(), mesh) == (Replicate(), Replicate())
    assert placements(P(None, None, "model"), mesh) == (Replicate(), Shard(2))
    # one dim over both axes, major first (the mesh's order)
    assert placements(P(("data", "model")), mesh) == (Shard(0), Shard(0))
    cfg = get_smoke("qwen2-moe-a2.7b")
    plan = make_plan(cfg, mesh=mesh, moe_ep=True)
    specs = init_param_specs(cfg, plan)
    assert placements(specs["embed"], mesh) == (Shard(1), Shard(0))
    assert placements(specs["blocks"]["pos0"]["we_g"], mesh) == \
        (Replicate(), Shard(1))
    with pytest.raises(ShardingError, match="out of the mesh's order"):
        placements(P(("model", "data")), mesh)
    with pytest.raises(ShardingError, match="not on this plan's mesh"):
        placements(P("pod"), mesh)
    with pytest.raises(ShardingError, match="two dims"):
        placements(P("data", "data"), mesh)


def test_plan_on_an_abstract_mesh_has_no_ranks():
    plan = make_plan(get_config("qwen2-moe-a2.7b"),
                     mesh=meshes("2x16x16")[1], moe_ep=True)
    assert isinstance(plan, ShardingPlan)
    assert not sh.is_device_mesh(plan.mesh)
    assert plan.axis_sizes_map() == {"pod": 2, "data": 16, "model": 16}
    assert plan.fsdp_size() == 16 and plan.axis_size(("pod", "data")) == 32
