"""Expert-parallel MoE and the LM stack under a ``ShardingPlan`` on four gloo
CPU ranks, a (data=2, model=2) mesh, held against the JAX package's
``shard_map`` on four forced XLA host devices; checkpoints saved on one
mesh and restored onto another, across both packages.

One ``run_ranks`` spawn runs every case of the port and one JAX subprocess
every case of the reference (``JaxReference``), side by side. The same
numpy parameters and inputs (``np_params``, ``np_inputs``, from seeds) go
to both. Smoke qwen2-moe-a2.7b and deepseek-v2-lite-16b in float32 under
``moe_ep``, the first also with a capacity that binds (each data shard
routes, buckets and drops its own tokens, with the capacity of its own
token count); qwen2-moe also under the plan without ``moe_ep`` (the global
batch routed at once, as the reference's ``moe_block`` under GSPMD), with
and without drops:

- ``layers.moe_block_ep`` on each data shard's rows: y within 1e-5 of
  max |y|, aux (the mean over the data shards) within 1e-6; both ranks of
  a model group hold the same bits;
- ``Model(cfg, plan).forward`` with the parameters placed by
  ``init_param_specs`` (``shard_tree``): logits within 1e-5 of max |logit|;
- both bitwise the plan-less ``moe_block`` and model on each data shard's
  rows alone;
- ``E % model_size`` raises ``ShardingError`` in both packages, with one
  text; a call that needs a gradient raises in the port;
- a checkpoint saved from (2, 2) restores onto (4, 1) and (1, 4)
  (``reshard_restore``), each rank's block bitwise the saved leaf's; JAX's
  ``restore_checkpoint`` reads the port's save bitwise; the port restores
  a checkpoint JAX saved onto (2, 2), bitwise.
"""
import functools

import numpy as np
import pytest

from torch_dist_parity import JaxReference, run_ranks

GRID = (2, 2)
AXES = ("data", "model")
B, S = 4, 32
# name: (architecture, capacity_factor (None: the smoke's), moe_ep)
CASES = {"qwen2-moe": ("qwen2-moe-a2.7b", None, True),
         "qwen2-moe-drops": ("qwen2-moe-a2.7b", 1.0, True),
         "deepseek-v2-lite": ("deepseek-v2-lite-16b", None, True),
         "qwen2-moe-gspmd": ("qwen2-moe-a2.7b", None, False),
         "qwen2-moe-gspmd-drops": ("qwen2-moe-a2.7b", 1.0, False)}
EP_CASES = [c for c in CASES if CASES[c][2]]
CKPT_CASE = "qwen2-moe"
REL_TOL, AUX_TOL = 1e-5, 1e-6


def case_cfg(get_smoke, case):
    arch, cf, _ = CASES[case]
    cfg = get_smoke(arch).scaled(dtype="float32", param_dtype="float32")
    return cfg if cf is None else cfg.scaled(capacity_factor=cf)


def np_params(shapes, seed=0):
    """A float32 parameter tree of ``shapes`` with the reference's
    distributions (norms one, embeddings 0.02, matrices 1/sqrt(fan_in)),
    one generator over the leaves in sorted path order."""
    rng = np.random.default_rng(seed)

    def build(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = build(v)
            elif k.startswith("ln") or k in ("final_norm", "kv_ln"):
                out[k] = np.ones(v, np.float32)
            else:
                fan_in = v[-2] if len(v) >= 2 else v[-1]
                std = 0.02 if k in ("embed", "lm_head") else fan_in ** -0.5
                out[k] = (rng.standard_normal(v) * std).astype(np.float32)
        return out

    return build(shapes)


def np_inputs(cfg, seed=1):
    """(x (B, S, D) float32 for one MoE layer, tokens (B, S) int32)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))


def first_layer(params):
    """Repeat 0 of period position 0 (a MoE layer in both smokes)."""
    return {k: v[0] for k, v in params["blocks"]["pos0"].items()}


# --------------------------------------------------------------------------
# JAX: one subprocess, four host devices
# --------------------------------------------------------------------------

def jax_side(F):
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke
    from repro.core import compat
    from repro.launch.mesh import make_plan
    from repro.models import layers as L
    from repro.models.model import Model, param_shapes

    # jax >= 0.9: the varying-axes check off, as torch_parity.jax_reference
    compat.shard_map = functools.partial(jax.shard_map, check_vma=False)
    mesh = compat.make_mesh(GRID, AXES)
    out = {}
    for case in CASES:
        cfg = case_cfg(get_smoke, case)
        plan = make_plan(cfg, mesh=mesh, moe_ep=CASES[case][2])
        params = np_params(param_shapes(cfg))
        x, tokens = np_inputs(cfg)
        out[case] = {}
        if plan.moe_ep:
            y, aux = jax.jit(lambda x, p: L.moe_block_ep(x, p, cfg, plan))(
                jnp.asarray(x), first_layer(params))
            out[case].update(y=np.asarray(y), aux=float(aux))
        # the model's constraints name the mesh's axes: a mesh in context
        with jax.set_mesh(mesh):
            logits, faux, _ = jax.jit(lambda p, t: Model(cfg, plan).forward(
                p, dict(tokens=t)))(params, jnp.asarray(tokens))
        out[case].update(logits=np.asarray(logits), faux=float(faux))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each port rank's results, JAX's, the port's checkpoint directory,
    the saved tree)."""
    from repro.configs.registry import get_smoke as jget_smoke
    from repro.models.model import param_shapes as jparam_shapes
    from repro.train.checkpoint import save_checkpoint as jsave
    ref = JaxReference("test_torch_moe_ep", "jax_side", [GRID])
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    tree = np_params(jparam_shapes(case_cfg(jget_smoke, CKPT_CASE)))
    jsave(jdir, 3, tree)
    pdir = str(tmp_path_factory.mktemp("port_ckpt"))
    ranks = run_ranks(port_side, 4, jdir, pdir)
    return ranks, ref.result()[GRID], pdir, tree


# --------------------------------------------------------------------------
# the port: four gloo ranks
# --------------------------------------------------------------------------

def _blocks_equal(tree, saved, specs, mesh):
    """Each leaf's block on this rank bitwise the saved global leaf's block
    under its spec."""
    import torch
    from repro_torch.dist import shardings as sh
    n = 0
    for k, v in tree.items():
        if isinstance(v, dict):
            n += _blocks_equal(v, saved[k], specs[k], mesh)
            continue
        want = sh.local_shard(torch.from_numpy(saved[k]), specs[k], mesh)
        got = sh.local(v)
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"{k}: block differs")
        n += 1
    return n


def port_side(rank, jdir, pdir):
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.dist import shardings as sh
    from repro_torch.launch.elastic import reshard_restore
    from repro_torch.launch.mesh import make_mesh, make_plan
    from repro_torch.models import Model
    from repro_torch.models import layers as L
    from repro_torch.models.model import init_param_specs, param_shapes
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.train.checkpoint import save_checkpoint

    mesh = make_mesh(GRID, AXES, device="cpu")
    out = {}
    for case in CASES:
        cfg = case_cfg(get_smoke, case)
        plan = make_plan(cfg, mesh=mesh, moe_ep=CASES[case][2])
        np_tree = np_params(param_shapes(cfg))
        x, tokens = np_inputs(cfg)
        rows = sh.dp_rows(plan, B)
        params = sh.shard_tree(params_from_numpy(np_tree, "cpu"),
                               init_param_specs(cfg, plan), mesh)
        with torch.no_grad():
            logits, faux, _ = Model(cfg, plan)(
                params, dict(tokens=torch.from_numpy(tokens)))
        out[case] = dict(logits=sh.gather(logits).numpy(), faux=float(faux))
        if not plan.moe_ep:
            continue
        layer = params_from_numpy(first_layer(np_tree), "cpu")
        with torch.no_grad():
            y, aux = L.moe_block_ep(torch.from_numpy(x[rows]), layer, cfg,
                                    plan)
            # the plan-less model on this data shard's rows alone
            y1, _ = L.moe_block(torch.from_numpy(x[rows]), layer, cfg)
            logits1, _, _ = Model(cfg)(
                params_from_numpy(np_tree, "cpu"),
                dict(tokens=torch.from_numpy(tokens[rows])))
        out[case].update(
            y=y.numpy(), aux=float(aux), plain_bits=(
                torch.equal(y, y1),
                torch.equal(sh.gather(logits, axes=(plan.model_axis,)),
                            logits1)))
        if case == CKPT_CASE:
            saved, specs = np_tree, init_param_specs(cfg, plan)
            whole = sh.gather_tree(params)
            save_checkpoint(pdir, 5, params)
            restored = {"gathered": all(
                torch.equal(a, torch.from_numpy(b)) for a, b in
                zip(_leaves(whole), _leaves(saved)))}
            for shape in ((4, 1), (1, 4)):
                m = make_mesh(shape, AXES, device="cpu")
                sp = init_param_specs(cfg, make_plan(cfg, mesh=m,
                                                     moe_ep=True))
                tree, step = reshard_restore(pdir, np_tree, mesh=m, specs=sp)
                restored[shape] = (step, _blocks_equal(tree, saved, sp, m))
            tree, step = reshard_restore(jdir, np_tree, mesh=mesh,
                                         specs=specs)
            restored["jax"] = (step, _blocks_equal(tree, saved, specs, mesh))
            out["restored"] = restored
    return out


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------

def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("case", EP_CASES)
def test_moe_block_ep_matches_jax(runs, case):
    ranks, jax_out, _, _ = runs
    want = jax_out[case]
    # rank r is (data, model) = divmod(r, 2): ranks 0, 1 hold rows 0-1
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a][case]["y"], ranks[b][case]["y"])
        assert ranks[a][case]["aux"] == ranks[b][case]["aux"]
    y = np.concatenate([ranks[0][case]["y"], ranks[2][case]["y"]])
    _close(y, want["y"], f"{case} y")
    for r in ranks:
        assert abs(r[case]["aux"] - want["aux"]) <= AUX_TOL, case


@pytest.mark.parametrize("case", list(CASES))
def test_model_forward_under_plan_matches_jax(runs, case):
    ranks, jax_out, _, _ = runs
    want = jax_out[case]
    for r in ranks:
        np.testing.assert_array_equal(r[case]["logits"],
                                      ranks[0][case]["logits"])
        assert abs(r[case]["faux"] - want["faux"]) <= AUX_TOL, case
    _close(ranks[0][case]["logits"], want["logits"], f"{case} logits")


@pytest.mark.parametrize("case", EP_CASES)
def test_plan_changes_no_bits(runs, case):
    """``moe_block_ep``'s output and the model's logits under the plan are
    bitwise those of the plan-less ``moe_block`` and model on each data
    shard's rows alone (each contribution has one owner; the combine keeps
    ``moe_block``'s order)."""
    ranks, _, _, _ = runs
    for r in ranks:
        assert r[case]["plain_bits"] == (True, True), case


@pytest.mark.parametrize("case", list(CASES))
def test_capacity_binds_in_the_drop_cases(case):
    """In a drop case some expert gets more choices than the capacity (so
    the case tests dropping: under moe_ep each data shard routes its own
    tokens with their own capacity, without it the global batch is routed
    at once); in the others the capacity holds every choice."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import param_shapes
    cfg = case_cfg(get_smoke, case)
    router = first_layer(np_params(param_shapes(cfg)))["router"]
    x, _ = np_inputs(cfg)
    shards = GRID[0] if CASES[case][2] else 1
    E, T = router.shape[-1], (B // shards) * S
    C = max(8, min(int(cfg.capacity_factor * T * cfg.top_k / E + 0.999), T))
    for rows in np.split(x, shards):
        logits = rows.reshape(T, -1) @ router
        logits[:, cfg.n_experts:] = -np.inf
        top = np.argsort(-logits, axis=1)[:, :cfg.top_k]
        most = np.bincount(top.ravel(), minlength=E).max()
        assert (most > C) == (CASES[case][1] is not None), (case, most, C)


def _plan_3(make_plan, mesh_cls, get_smoke):
    cfg = case_cfg(get_smoke, "qwen2-moe")
    return cfg, make_plan(cfg, mesh=mesh_cls((1, 3), AXES), moe_ep=True)


def test_indivisible_experts_raise_as_jax():
    import torch
    from jax.sharding import AbstractMesh as JAbstractMesh
    from repro.configs.registry import get_smoke as jget_smoke
    from repro.dist.shardings import ShardingError as JShardingError
    from repro.launch.mesh import make_plan as jmake_plan
    from repro.models import layers as JL
    from repro_torch.configs import get_smoke
    from repro_torch.dist.shardings import ShardingError
    from repro_torch.launch.mesh import AbstractMesh, make_plan
    from repro_torch.models import layers as L

    cfg, plan = _plan_3(make_plan, AbstractMesh, get_smoke)
    jcfg, jplan = _plan_3(jmake_plan, JAbstractMesh, jget_smoke)
    p = {"router": torch.zeros(cfg.d_model, 16)}
    with pytest.raises(ShardingError) as got:
        L.moe_block_ep(torch.zeros(2, S, cfg.d_model), p, cfg, plan)
    with pytest.raises(JShardingError) as want:
        JL.moe_block_ep(np.zeros((2, S, cfg.d_model), np.float32),
                        {"router": np.zeros((cfg.d_model, 16), np.float32)},
                        jcfg, jplan)
    assert str(got.value) == str(want.value)
    assert "not divisible by the expert-parallel axis 'model'" in \
        str(got.value)


def test_moe_block_ep_refuses_a_gradient():
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import AbstractMesh, make_plan
    from repro_torch.models import layers as L
    from repro_torch.models.model import param_shapes
    cfg = case_cfg(get_smoke, "qwen2-moe")
    plan = make_plan(cfg, mesh=AbstractMesh(GRID, AXES), moe_ep=True)
    layer = {k: torch.from_numpy(v) for k, v in
             first_layer(np_params(param_shapes(cfg))).items()}
    x = torch.zeros(2, S, cfg.d_model, requires_grad=True)
    with pytest.raises(RuntimeError, match="moe_block_ep.*no backward"):
        L.moe_block_ep(x, layer, cfg, plan)


@pytest.mark.parametrize("where", [(4, 1), (1, 4)], ids=["4x1", "1x4"])
def test_checkpoint_restores_onto_another_mesh(runs, where):
    ranks, _, _, tree = runs
    n = sum(1 for _ in _leaves(tree))
    for r in ranks:
        assert r["restored"][where] == (5, n)


def test_jax_restores_the_ports_checkpoint(runs):
    from repro.train.checkpoint import restore_checkpoint as jrestore
    _, _, pdir, tree = runs
    got, step = jrestore(pdir, tree)
    assert step == 5
    for (a, b) in zip(_leaves(got), _leaves(tree)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_gather_tree_inverts_shard_tree(runs):
    ranks, _, _, _ = runs
    assert all(r["restored"]["gathered"] for r in ranks)


def test_port_restores_a_jax_checkpoint_sharded(runs):
    ranks, _, _, tree = runs
    n = sum(1 for _ in _leaves(tree))
    for r in ranks:
        assert r["restored"]["jax"] == (3, n)


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]
