"""Production meshes — CombBLAS grids for the LM stack (port of
``repro/launch/mesh.py``).

  single-pod: (data=16, model=16)        = the paper's √p×√p 2D grid
  multi-pod : (pod=2, data=16, model=16) = the paper's c×√(p/c)×√(p/c) 3D
              CA grid; 'pod' is the layer axis (hierarchical collectives).

A mesh of ranks is a ``torch.distributed`` ``DeviceMesh`` with named dims
over world ranks 0 .. n-1, rank-major as ``core/comm.py`` places a grid
(``make_mesh``); an ``AbstractMesh`` has axis names and sizes and no
processes, for plans and spec trees of meshes larger than the world (the
reference's ``jax.sharding.AbstractMesh``). Functions, not module
constants: importing this module touches no process group.
"""
from __future__ import annotations

from ..core.coo import resolve_device

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}

MODEL_AXIS = "model"


class AbstractMesh:
    """Axis names and sizes without ranks: ``AbstractMesh((16, 16),
    ("data", "model"))``. ``shape`` maps name -> size, as JAX's."""

    def __init__(self, axis_sizes, axis_names):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{len(axis_sizes)} sizes for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(s) for s in axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_mesh(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over world
    ranks 0 .. n-1, rank-major (rank r at the coordinates of r in C order,
    as ``core/comm.py`` lays out a grid). Every world rank calls it (its
    groups are made collectively). ``device`` None means the GPU (raising
    when there is none); a card's mesh holds each rank's card (several
    ranks may share one: their gathers then cross through the card's memory,
    ``comm.CardMailbox``, opened by ``comm.init_world``). Raises
    ``RuntimeError`` when the world is smaller than the mesh."""
    import torch

    from ..core import comm
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = 1
    for s in shape:
        n *= s
    world = comm.world()[1]
    if world < n:
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a world of {n} "
            f"ranks (torch.distributed initialized with one process a "
            f"rank, e.g. comm.init_world); it has {world}")
    dev = resolve_device(device)
    return comm.DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                           mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    from ..core import comm
    ndev = 1
    for s in shape:
        ndev *= s
    world = comm.world()[1]
    if world < ndev:
        raise RuntimeError(
            f"need {ndev} devices for the production mesh, have {world} "
            f"ranks — join a world of {ndev} ranks (torch.distributed, "
            f"one process a rank), or build plans on an AbstractMesh")
    return make_mesh(shape, axes, device=device)


def make_plan(cfg, *, multi_pod: bool = False, shape_kind: str = "train",
              batch: int = 0, seq_parallel: bool = False, mesh=None,
              moe_ep: bool = False):
    """ShardingPlan matched to (mesh, arch, shape).

    Axis layout comes from the mesh when one is given (a ``DeviceMesh`` or
    an ``AbstractMesh``); without a mesh it falls back to the production
    shapes above. All non-model axes are data parallel; only the innermost
    ('data') axis shards parameters — the pod axis is pure DP.
    """
    from ..dist.shardings import ShardingPlan, mesh_axis_sizes
    if mesh is not None:
        sizes = mesh_axis_sizes(mesh)
        axes = tuple(sizes)
    else:
        shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
        sizes = dict(zip(axes, shape))
    if MODEL_AXIS not in sizes or len(axes) < 2:
        raise ValueError(
            f"plan needs a mesh with a {MODEL_AXIS!r} axis and ≥1 data "
            f"axis, got {dict(sizes)}")
    dp_axes = tuple(a for a in axes if a != MODEL_AXIS)
    dp_size = 1
    for a in dp_axes:
        dp_size *= sizes[a]
    model_size = sizes[MODEL_AXIS]
    context_parallel = shape_kind == "decode" and batch < dp_size
    return ShardingPlan(
        dp_axes=dp_axes, model_axis=MODEL_AXIS, model_size=model_size,
        fsdp_axes=(dp_axes[-1],),     # params sharded within a pod; outer
        # dp axes (pod) are pure DP with hierarchical grad reduction
        seq_parallel=seq_parallel,
        context_parallel=context_parallel,
        dp_size=dp_size, moe_ep=moe_ep, mesh=mesh, axis_sizes=sizes)
