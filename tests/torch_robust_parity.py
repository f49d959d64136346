"""The JAX package's guarded multiplies as the reference of the robust tests.

The JAX package's ``guard_exchange`` reads its operands on the host (the
checksums, the fault hooks), so it cannot run under ``jax.jit``; run
eagerly, a ``shard_map`` multiply compiles every primitive on each call
(some 25 s for one 40-vertex ``spgemm_2d`` on the sandbox CPU). Here the
guards run eagerly, on concrete arrays, exactly where the JAX package
calls them, and the multiply itself runs under one jit per configuration
with the guards (and the output audits, run eagerly after it) turned to
the identity while it is traced:

- ``spgemm_2d``: the ``spgemm2d.comm_a``/``comm_b`` guards, then (with
  ``compress='int8'``) the JAX package's ``_compress_operand`` eagerly —
  its quantization and its ``dist.compressed_exchange`` guard — whose
  results the jitted multiply takes as arguments; ``spgemm2d.out``'s audit.
- ``spmspv``: the ``spmspv.comm_x`` guard and ``spmspv.out``'s audit.
- the 'postfilter' rung's ``postfilter_2d``, jitted whole (it has no guard).

``merge.kv_ok`` fires when the JAX package traces its kv tree, and the
legacy-dedup switch is read there too, so the jit cache key holds both: a
call under either compiles its own program, as every eager call would. The computation is the JAX package's
unchanged. ``jax_robust_reference()`` installs both on the JAX planner
(on top of ``torch_parity.jax_reference``'s ``check_vma=False``).
"""
import contextlib
import dataclasses
import sys

import jax
import pytest

import repro.core.plan as _jplan
import repro.robust.audit  # noqa: F401  (the modules, through sys.modules)
import repro.robust.faults  # noqa: F401
import repro.robust.recover  # noqa: F401
import torch_parity as tp

# the packages' __init__s shadow some modules with same-named functions
_jspgemm = sys.modules["repro.core.spgemm"]
_jaudit = sys.modules["repro.robust.audit"]
_jfaults = sys.modules["repro.robust.faults"]
_jmerge = sys.modules["repro.core.merge"]
_jrecover = sys.modules["repro.robust.recover"]

_CORE = {}


def _traced_switches():
    """What the JAX package reads while it traces: whether
    ``merge.kv_ok`` is armed and whether the legacy dedup is forced."""
    return (any(f.site == "merge.kv_ok" for f in _jfaults.active()),
            _jmerge.legacy_dedup_forced())


@contextlib.contextmanager
def _traced_unguarded(pre=None):
    """While tracing: the guards and audits are the identity, and
    ``_compress_operand`` hands out the eagerly computed results."""
    mp = pytest.MonkeyPatch()
    mp.setattr(_jaudit, "guard_exchange", lambda site, obj: obj)
    mp.setattr(_jaudit, "audit_obj", lambda *a, **k: None)
    if pre is not None:
        it = iter(pre)
        mp.setattr(_jspgemm, "_compress_operand",
                   lambda mat, sr, site, resid=None: next(it))
    try:
        yield
    finally:
        mp.undo()


_ORIG_COMPRESS = _jspgemm._compress_operand
_ORIG_SPMSPV = tp._ORIG_SPMSPV            # repro.core.spmv.spmspv


def jax_spgemm_2d(a, b, sr, *, mesh, prod_cap, out_cap, variant="rotation",
                  merge="deferred", mask=None, schedule=None, overlap=True,
                  compress=None, ef_resid=None):
    """``repro.core.spgemm.spgemm_2d`` with its guards run eagerly."""
    a = _jaudit.guard_exchange("spgemm2d.comm_a", a)
    b = _jaudit.guard_exchange("spgemm2d.comm_b", b)
    pre = None
    if compress is not None:
        pre = (_ORIG_COMPRESS(a, sr, "dist.compressed_exchange", ef_resid),
               _ORIG_COMPRESS(b, sr, "dist.compressed_exchange"))
    key = ("2d", sr, mesh, prod_cap, out_cap, variant, merge, schedule,
           overlap, compress, mask is None, ef_resid is None,
           _traced_switches(),
           None if mask is None else (mask.complement, mask.pred,
                                      mask.val_pred))
    if key not in _CORE:
        def run(a, b, mat, resid, pre):
            m = None if mask is None else dataclasses.replace(mask, mat=mat)
            with _traced_unguarded(pre):
                return _jspgemm.spgemm_2d(
                    a, b, sr, mesh=mesh, prod_cap=prod_cap, out_cap=out_cap,
                    variant=variant, merge=merge, mask=m, schedule=schedule,
                    overlap=overlap, compress=compress, ef_resid=resid)
        _CORE[key] = jax.jit(run)
    out = _CORE[key](a, b, None if mask is None else mask.mat, ef_resid, pre)
    _jaudit.audit_obj(out[0], "spgemm2d.out", min_level=_jaudit.FULL)
    return out


def jax_spmspv(a, x, sr, *, mesh, variant, merge, prod_cap, out_cap,
               mask=None):
    """``repro.core.spmv.spmspv`` with its guard run eagerly."""
    x = _jaudit.guard_exchange("spmspv.comm_x", x)
    key = ("spmspv", sr, mesh, variant, merge, prod_cap, out_cap,
           _traced_switches(), None if mask is None else (mask.complement, mask.pred.__code__))
    if key not in _CORE:
        def run(a, x, vec):
            m = None if mask is None else dataclasses.replace(mask, vec=vec)
            with _traced_unguarded():
                return _ORIG_SPMSPV(a, x, sr, mesh=mesh, variant=variant,
                                    merge=merge, prod_cap=prod_cap,
                                    out_cap=out_cap, mask=m)
        _CORE[key] = jax.jit(run)
    y, ok = _CORE[key](a, x, None if mask is None else mask.vec)
    _jaudit.audit_obj(y, "spmspv.out", min_level=_jaudit.FULL)
    return y, ok


_ORIG_POSTFILTER = _jrecover.postfilter_2d


def jax_postfilter_2d(c, mask, sr, *, mesh):
    """``repro.robust.recover.postfilter_2d`` (the 'postfilter' rung's
    explicit mask) under one jit per configuration."""
    key = ("postfilter", sr, mesh, mask.complement, mask.pred, mask.val_pred)
    if key not in _CORE:
        _CORE[key] = jax.jit(lambda c, mat: _ORIG_POSTFILTER(
            c, dataclasses.replace(mask, mat=mat), sr, mesh=mesh))
    return _CORE[key](c, mask.mat)


@contextlib.contextmanager
def jax_robust_reference():
    """The JAX planner over the guarded multiplies above."""
    mp = pytest.MonkeyPatch()
    with tp.jax_reference():
        mp.setattr(_jplan, "_spgemm_2d", jax_spgemm_2d)
        mp.setattr(_jplan, "_spmspv_2d", jax_spmspv)
        mp.setattr(_jrecover, "postfilter_2d", jax_postfilter_2d)
        try:
            yield
        finally:
            mp.undo()
