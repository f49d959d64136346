"""Parameter and activation sharding plans of the LM stack (port of
``repro/dist/shardings.py``), and trees placed on a named mesh.

The plan maps every parameter and activation of every registry
architecture onto the process grids of ``launch/mesh.py``

  single-pod: (data=16, model=16)        — the paper's √p×√p 2D grid
  multi-pod : (pod=2, data=16, model=16) — the c×√(p/c)×√(p/c) CA 3D grid

through the reference's two exports:

  ``ShardingPlan``   — how the grid axes are spent (data, tensor, sequence,
                       context and expert parallelism), with the plan-side
                       spec helpers ``dp()``, ``cache_spec``, ``act_spec``,
                       ``ep_spec``, ``logits_spec``.
  ``spec_for_param`` — the per-parameter rule table, keyed by parameter
                       path. Every family of ``models/model.param_shapes``
                       has an explicit rule; an unknown path raises
                       instead of silently replicating.

Specs are this module's ``PartitionSpec`` (``P``), a tuple with one entry
a dimension (None, an axis name or a tuple of names), so a spec compares
equal to the reference's entry for entry. Rules, layouts and error texts
are the reference's (its module docstring has the layout discipline: the
model axis is tensor parallelism, ``fsdp_axes`` ZeRO-3, the pod axis in no
parameter spec).

On a mesh of ranks (a ``torch.distributed`` ``DeviceMesh`` with named
dims, ``launch/mesh.make_mesh``) a spec becomes DTensor placements
(``placements``: ``Shard(d)`` or ``Replicate()`` a mesh dim, the
counterpart of ``NamedSharding(mesh, spec)``), and a leaf is a DTensor
holding this rank's block: ``shard``/``shard_tree`` place a global tensor,
``gather``/``gather_many``/``gather_tree`` assemble it again. The
exchanges are ``core/comm.py``'s over the mesh's groups (ranks that share
one card gather through its memory, ``comm.CardMailbox``), booked under
the tag ``"leaf_gather"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from ..core import comm
from ..core.comm import DeviceMesh, DTensor, Replicate, Shard


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry a dimension, None (whole),
    an axis name, or a tuple of names (one dimension over several axes,
    major first); dimensions past the last entry are whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):                  # the reference's, so error texts
        return f"PartitionSpec{tuple.__repr__(self)}"     # match it


P = PartitionSpec


class ShardingError(ValueError):
    """A spec that would silently mis-shard: wrong axis, reuse, or a
    sharded dimension not divisible by the axis size."""


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _entry(axes):
    """Normalize an axis collection to a PartitionSpec entry."""
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _axes(entry) -> tuple:
    return () if entry is None else \
        entry if isinstance(entry, tuple) else (entry,)


def mesh_axis_sizes(mesh) -> dict:
    """name -> size of every axis of ``mesh``, in its order: a
    ``DeviceMesh`` (``mesh_dim_names`` and the ``shape`` tuple) or an
    ``AbstractMesh`` (``shape`` a mapping, as JAX's)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def is_device_mesh(mesh) -> bool:
    """Whether ``mesh`` is a mesh of ranks (not an ``AbstractMesh``)."""
    return isinstance(mesh, DeviceMesh)


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How the mesh axes are spent for one (arch × shape × mesh) cell.

    Built by ``launch/mesh.make_plan``; consumed by ``models/model.py``
    (parameter specs, activation constraints, the MoE dispatch) and
    ``train/checkpoint.py`` (a restore onto the plan's mesh).
    """
    dp_axes: tuple[str, ...]          # all data-parallel axes (pod, data)
    model_axis: str                   # tensor-parallel axis name
    model_size: int                   # size of the model axis
    fsdp_axes: tuple[str, ...]        # ⊆ dp_axes: param-sharding (ZeRO-3)
    seq_parallel: bool                # shard activation seq over model
    context_parallel: bool            # decode w/ batch < dp: shard the
    # cache SEQUENCE over the dp axes instead of the (unshardable) batch
    dp_size: int                      # product of dp axis sizes
    moe_ep: bool                      # expert-parallel MoE dispatch
    mesh: Any = None                  # DeviceMesh, AbstractMesh or None
    axis_sizes: Optional[Mapping[str, int]] = None   # name → size; derived
    # from the mesh when one is given (make_plan fills this in)

    def __post_init__(self):
        sizes = self.axis_sizes_map()
        for ax in self.fsdp_axes:
            if ax not in self.dp_axes:
                raise ShardingError(
                    f"fsdp axis {ax!r} is not a dp axis {self.dp_axes}")
        if self.model_axis in self.dp_axes:
            raise ShardingError(
                f"model axis {self.model_axis!r} overlaps dp {self.dp_axes}")
        if sizes:
            got = sizes.get(self.model_axis)
            if got is not None and got != self.model_size:
                raise ShardingError(
                    f"model_size {self.model_size} != mesh axis "
                    f"{self.model_axis!r} size {got}")
            dp = [sizes[a] for a in self.dp_axes if a in sizes]
            if len(dp) == len(self.dp_axes) and _prod(dp) != self.dp_size:
                raise ShardingError(
                    f"dp_size {self.dp_size} != product of dp axes "
                    f"{dict(zip(self.dp_axes, dp))}")

    # ---------------- axis bookkeeping ----------------
    def axis_sizes_map(self) -> dict[str, int]:
        """name → size for every mesh axis this plan can legally use."""
        if self.mesh is not None:
            return mesh_axis_sizes(self.mesh)
        if self.axis_sizes is not None:
            return dict(self.axis_sizes)
        sizes = {self.model_axis: self.model_size}
        if len(self.dp_axes) == 1:
            sizes[self.dp_axes[0]] = self.dp_size
        return sizes                   # multi-dp w/o mesh: pod split unknown

    def axis_size(self, entry) -> int:
        """Total shard count of a spec entry (axis name or tuple)."""
        if entry is None:
            return 1
        axes = _axes(entry)
        sizes = self.axis_sizes_map()
        missing = [a for a in axes if a not in sizes]
        if missing:
            raise ShardingError(f"axes {missing} not on this plan's mesh "
                                f"(have {sorted(sizes)})")
        return _prod(sizes[a] for a in axes)

    def fsdp_size(self) -> int:
        return self.axis_size(_entry(self.fsdp_axes)) if self.fsdp_axes \
            else 1

    # ---------------- spec helpers (plan side) ----------------
    def dp(self):
        """Spec entry sharding a batch dim over ALL data axes."""
        return _entry(self.dp_axes)

    def fsdp(self):
        """Spec entry for the parameter-sharding (ZeRO) axes, or None."""
        return _entry(self.fsdp_axes)

    def _tp_if(self, dim_size: int):
        """Model-axis entry when the dim divides evenly, else None (for
        activation and cache layouts; parameters go through the strict
        rule table)."""
        return self.model_axis if dim_size % self.model_size == 0 else None

    def act_spec(self) -> P:
        """(B, S, D) activation constraint at block boundaries."""
        batch = None if self.context_parallel else self.dp()
        seq = self.model_axis if self.seq_parallel else None
        return P(batch, seq, None)

    def logits_spec(self) -> P:
        """(B, S, vocab_padded): vocab over model (vocab_padded is a
        multiple of 256, so it always divides)."""
        batch = None if self.context_parallel else self.dp()
        return P(batch, None, self.model_axis)

    def ep_spec(self) -> P:
        """(E, C, D) MoE dispatch buffer: experts over the model axis, the
        at-rest layout of the expert weights (padding experts make E
        divide)."""
        return P(self.model_axis, None, None)

    def cache_spec(self, kind: str, dims: Mapping[str, int]) -> tuple:
        """Decode-cache layout for one cache family (no leading reps dim
        — callers prepend it: ``P(None, *plan.cache_spec(...))``).

        kind='kv'      (B, S, KVH, hd)   dims: kvh, hd
        kind='kv_flat' (B, S, X)         dims: x   (MLA latent)
        kind='ssm'     (B, H, P, N)      dims: h
        kind='conv'    (B, W, C)         dims: c

        Batch shards over the dp axes; under context_parallel the SEQUENCE
        dim takes them instead. The head-ish dim takes the model axis when
        divisible; 'kv' falls back to sharding head_dim when n_kv_heads <
        model_size (GQA), and the MLA shared rope key (kvh=1) lands there
        too.
        """
        batch = None if self.context_parallel else self.dp()
        seq = self.dp() if self.context_parallel else None
        if kind == "kv":
            kvh, hd = int(dims["kvh"]), int(dims["hd"])
            if kvh % self.model_size == 0:
                heads, head_dim = self.model_axis, None
            else:
                heads, head_dim = None, self._tp_if(hd)
            return (batch, seq, heads, head_dim)
        if kind == "kv_flat":
            return (batch, seq, self._tp_if(int(dims["x"])))
        if kind == "ssm":
            return (batch, self._tp_if(int(dims["h"])), None, None)
        if kind == "conv":
            return (batch, None, self._tp_if(int(dims["c"])))
        raise ShardingError(f"unknown cache kind {kind!r} "
                            "(want kv | kv_flat | ssm | conv)")


# --------------------------------------------------------------------------
# spec validation
# --------------------------------------------------------------------------

def validate_spec(spec: P, shape: tuple, plan: ShardingPlan,
                  path: str = "?") -> P:
    """Check one spec against the mesh axes and the array shape.

    Raises ShardingError on: rank mismatch, an axis not on the mesh, an
    axis used on two dims, or a sharded dim not divisible by the total
    shard count of its entry. Returns the spec unchanged on success.
    """
    if len(spec) > len(shape):
        raise ShardingError(
            f"{path}: spec {spec} has more entries than shape {shape}")
    seen: list[str] = []
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in _axes(entry):
            if not isinstance(ax, str):
                raise ShardingError(f"{path}: bad spec entry {entry!r}")
            if ax in seen:
                raise ShardingError(
                    f"{path}: axis {ax!r} used on two dims of {spec}")
            seen.append(ax)
        n = plan.axis_size(entry)      # raises on unknown axes
        if shape[d] % n:
            raise ShardingError(
                f"{path}: dim {d} of shape {shape} ({shape[d]}) is not "
                f"divisible by {entry!r} (size {n}) in spec {spec}")
    return spec


def validate_spec_tree(specs, shapes, plan: ShardingPlan, prefix: str = ""):
    """Validate a nested dict of specs against the matching shape tree.

    Also checks tree congruence: the two trees must have identical keys.
    """
    if isinstance(shapes, dict) != isinstance(specs, dict):
        raise ShardingError(f"{prefix or '<root>'}: tree mismatch "
                            f"({type(specs).__name__} vs "
                            f"{type(shapes).__name__})")
    if isinstance(shapes, dict):
        if set(specs) != set(shapes):
            raise ShardingError(
                f"{prefix or '<root>'}: key mismatch "
                f"{sorted(set(specs) ^ set(shapes))}")
        for k in shapes:
            validate_spec_tree(specs[k], shapes[k], plan,
                               f"{prefix}/{k}" if prefix else k)
    else:
        validate_spec(specs, tuple(shapes), plan, prefix)


# --------------------------------------------------------------------------
# per-parameter rules
# --------------------------------------------------------------------------
#
# One rule per parameter family: (tp_dim, fsdp_dim) indices into the
# UNSTACKED shape (block params carry a leading period-repeats dim that is
# never sharded). tp_dim takes the model axis; fsdp_dim takes
# plan.fsdp_axes. None = that kind of sharding does not apply to the
# family. The reference's table of families and shapes applies as it is.
#
# † under plan.moe_ep the expert weights drop their fsdp dim: the
#   expert-parallel dispatch consumes them as P(model, None, None), each
#   rank's experts whole.

_TOP_RULES: dict[str, tuple] = {
    "embed":       (0, 1),
    "lm_head":     (0, 1),
    "final_norm":  (None, 0),
    "vision_proj": (1, 0),
    "frame_proj":  (1, 0),
}

_BLOCK_RULES: dict[str, tuple] = {
    # norms
    "ln1": (None, 0), "ln2": (None, 0), "kv_ln": (None, 0),
    # attention (GQA + MLA share wq/wo)
    "wq": (1, 0), "wk": (1, 0), "wv": (1, 0),
    "bq": (0, None), "bk": (0, None), "bv": (0, None),
    "wo": (0, 1),
    "w_dkv": (1, 0), "w_ukv": (1, 0),
    # mamba2 / SSD
    "in_z": (1, 0), "in_xbc": (1, 0), "in_dt": (1, 0),
    "conv_w": (1, None),
    "A_log": (0, None), "dt_bias": (0, None), "D_skip": (0, None),
    "out_proj": (0, 1),
    # MoE
    "router": (None, 0),
    "we_g": (0, 2), "we_1": (0, 2), "we_2": (0, 1),
    "ws_g": (2, 1), "ws_1": (2, 1), "ws_2": (1, 2),
    # dense MLP (silu pair or gelu)
    "wg": (1, 0), "w1": (1, 0), "w2": (0, 1),
}

MOE_EXPERT_PARAMS = ("we_g", "we_1", "we_2")


def spec_for_param(path: str, shape: tuple, cfg, plan: ShardingPlan) -> P:
    """PartitionSpec for one parameter of ``models/model.param_shapes``.

    path: '/'-joined tree path ('embed', 'blocks/pos3/wq', ...).
    Raises ShardingError for unknown families or indivisible layouts —
    there is deliberately no replicated fallback.
    """
    shape = tuple(shape)
    name = path.split("/")[-1]
    in_block = path.startswith("blocks/")
    rules = _BLOCK_RULES if in_block else _TOP_RULES
    if name not in rules:
        raise ShardingError(
            f"no sharding rule for parameter {path!r} (shape {shape}): "
            "add its family to dist/shardings "
            f"{'_BLOCK_RULES' if in_block else '_TOP_RULES'}")
    tp_dim, fsdp_dim = rules[name]
    lead = 1 if in_block else 0        # stacked period-repeats dim
    base = shape[lead:]
    expect = max([d for d in (tp_dim, fsdp_dim) if d is not None],
                 default=0) + 1
    if len(base) < expect:
        raise ShardingError(
            f"{path}: shape {shape} has rank {len(base)} (+{lead} stacked), "
            f"family {name!r} expects rank ≥ {expect}")

    if plan.moe_ep and name in MOE_EXPERT_PARAMS:
        fsdp_dim = None                # see † above

    entries: list = [None] * len(shape)
    if tp_dim is not None:
        d = lead + tp_dim
        if base[tp_dim] % plan.model_size:
            raise ShardingError(
                f"{path}: dim {d} ({base[tp_dim]}) not divisible by model "
                f"axis {plan.model_axis!r} (size {plan.model_size}) — "
                f"shape {shape}")
        entries[d] = plan.model_axis
    if fsdp_dim is not None and plan.fsdp_axes:
        d = lead + fsdp_dim
        n = plan.fsdp_size()
        if base[fsdp_dim] % n:
            raise ShardingError(
                f"{path}: dim {d} ({base[fsdp_dim]}) not divisible by fsdp "
                f"axes {plan.fsdp_axes} (size {n}) — shape {shape}")
        entries[d] = plan.fsdp()
    spec = P(*entries)
    return validate_spec(spec, shape, plan, path)


# --------------------------------------------------------------------------
# specs on a mesh of ranks: placements, shards, gathers
# --------------------------------------------------------------------------

def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` where the spec's entry d names that axis, else
    ``Replicate()``. An entry over several axes must name them in the
    mesh's order (a DTensor splits one dim over several mesh dims in mesh
    order, as the reference's major-first entry does)."""
    names = tuple(mesh_axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        at = []
        for ax in _axes(entry):
            if ax not in names:
                raise ShardingError(f"axes [{ax!r}] not on this plan's mesh "
                                    f"(have {sorted(names)})")
            if isinstance(out[names.index(ax)], Shard):
                raise ShardingError(f"axis {ax!r} used on two dims of "
                                    f"{spec}")
            at.append(names.index(ax))
            out[at[-1]] = Shard(d)
        if at != sorted(at):
            raise ShardingError(f"{spec}: entry {entry!r} names its axes out "
                                f"of the mesh's order {names}")
    return tuple(out)


def _block_index(spec: P, mesh) -> list:
    """This rank's (start, size) block of each dim under ``spec``: its
    coordinates on the entry's axes read major first."""
    sizes = mesh_axis_sizes(mesh)
    names = tuple(sizes)
    coord = mesh.get_coordinate()
    out = []
    for entry in spec:
        k, n = 0, 1
        for ax in _axes(entry):
            k = k * sizes[ax] + coord[names.index(ax)]
            n *= sizes[ax]
        out.append((k, n))
    return out


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec``, a contiguous
    copy (the global tensor can be freed after)."""
    for d, (k, n) in enumerate(_block_index(spec, mesh)):
        if x.shape[d] % n:
            raise ShardingError(f"dim {d} of shape {tuple(x.shape)} is not "
                                f"divisible by {n} in spec {spec}")
        size = x.shape[d] // n
        x = x.narrow(d, k * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def from_local(local: torch.Tensor, spec: P, mesh, shape) -> DTensor:
    """A DTensor of global ``shape`` whose block on this rank is ``local``
    (no exchange)."""
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def shard(x: torch.Tensor, spec: P, mesh) -> DTensor:
    """``x`` (the same global tensor on every rank, on any device) placed on
    ``mesh`` by ``spec``, this rank's block on the mesh's device:
    ``jax.device_put(x, NamedSharding(mesh, spec))``."""
    return from_local(local_shard(x, spec, mesh).to(mesh.device_type), spec,
                      mesh, x.shape)


def gather_many(vs, axes=None) -> list:
    """The global tensors of several DTensors on one mesh (``full_tensor()``
    of each), or only whole over the mesh dims named in ``axes`` (still
    split on the others); plain tensors as they are. Over each sharding
    mesh dim, minor first, one of ``core/comm.py``'s gathers carries every
    leaf split on it (``comm.all_gather_fields``), booked under the tag
    ``"leaf_gather"``; a gather is a concatenation, so it is exact."""
    out = list(vs)
    dts = [i for i, v in enumerate(vs) if isinstance(v, DTensor)]
    if not dts:
        return out
    mesh = vs[dts[0]].device_mesh
    names = mesh.mesh_dim_names
    mc = comm.mesh_comm(mesh)
    for i in dts:
        out[i] = vs[i].to_local()
    with comm.tagged("leaf_gather"):
        for a in reversed(range(len(names))):          # minor axes first
            if axes is not None and names[a] not in axes:
                continue
            on = [(i, vs[i].placements[a].dim) for i in dts
                  if isinstance(vs[i].placements[a], Shard)]
            if not on:
                continue
            members = comm.all_gather_fields(
                [out[i].movedim(d, 0) for i, d in on], mc, names[a])
            for j, (i, d) in enumerate(on):
                out[i] = torch.cat([m[j] for m in members]).movedim(0, d)
    for i in dts:
        out[i] = out[i].contiguous()
    return out


def gather(v, axes=None) -> torch.Tensor:
    """The global tensor of a DTensor (``gather_many`` of one); a plain
    tensor as it is."""
    return gather_many([v], axes)[0]


def local(v) -> torch.Tensor:
    """This rank's block of a DTensor (no exchange); a plain tensor as it
    is."""
    return v.to_local() if isinstance(v, DTensor) else v


def redistribute(v, spec: P):
    """A DTensor at ``spec``'s placements on its mesh: the mesh dims that
    stop splitting a dim are gathered first (``gather``), then each newly
    split dim keeps this rank's block (no exchange); a plain tensor as it
    is. (DTensor's own collectives are not used: on a gloo group they do
    not stage a CUDA payload through host memory.)"""
    if not isinstance(v, DTensor):
        return v
    mesh, have = v.device_mesh, tuple(v.placements)
    want = placements(spec, mesh)
    if want == have:
        return v
    names = mesh.mesh_dim_names
    drop = [names[i] for i, (h, w) in enumerate(zip(have, want))
            if isinstance(h, Shard) and h != w]
    if drop:
        have = tuple(Replicate() if names[i] in drop else p
                     for i, p in enumerate(have))
        v = DTensor.from_local(gather(v, axes=drop), mesh, have,
                               run_check=False, shape=v.shape,
                               stride=v.stride())
    return v.redistribute(mesh, want)


def unstack(v) -> list:
    """A stacked leaf's repeats (its leading dim), each a DTensor over the
    same mesh with the repeats dim (never sharded) dropped; a plain tensor's
    ``unbind(0)``."""
    if not isinstance(v, DTensor):
        return list(v.unbind(0))
    pls = v.placements
    if any(isinstance(p, Shard) and p.dim == 0 for p in pls):
        raise ShardingError("a stacked leaf's repeats dim is sharded")
    pls = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pls)
    shape, stride = v.shape[1:], torch.empty(v.shape[1:],
                                             device="meta").stride()
    return [DTensor.from_local(t, v.device_mesh, pls, run_check=False,
                               shape=shape, stride=stride)
            for t in v.to_local().unbind(0)]


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` placed on ``mesh`` by the matching spec of
    ``specs`` (a tree of the same keys)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard(tree, specs, mesh)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` gathered (``gather``), in the tree's
    order: a collective, every rank of the mesh calls it."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return gather(tree)


# --------------------------------------------------------------------------
# batch rows of a data shard
# --------------------------------------------------------------------------

def dp_index(plan: ShardingPlan) -> int:
    """This rank's data shard: its coordinates on the dp axes, major
    first."""
    mc = comm.mesh_comm(plan.mesh)
    k = 0
    for ax in plan.dp_axes:
        k = k * mc.size(ax) + mc.index(ax)
    return k


def dp_rows(plan: ShardingPlan, batch: int) -> slice:
    """The rows of a global batch of ``batch`` rows that this rank's data
    shard holds."""
    if batch % plan.dp_size:
        raise ShardingError(f"a batch of {batch} rows does not split over "
                            f"the {plan.dp_size} data shards {plan.dp_axes}")
    n = batch // plan.dp_size
    k = dp_index(plan)
    return slice(k * n, (k + 1) * n)


def gather_rows(x: torch.Tensor, plan: ShardingPlan) -> torch.Tensor:
    """The global batch from each data shard's rows ``x`` (dim 0), in row
    order."""
    mc = comm.mesh_comm(plan.mesh)
    for ax in reversed(plan.dp_axes):
        x = comm.all_gather(x, mc, ax, tiled=True)
    return x
