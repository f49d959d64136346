"""Parity of the port's training substrate with the JAX package: AdamW
(``lr_schedule``, ``global_norm``, ``adamw_update``), ``make_train_step``
(one and two steps, ``accum=2``, ``compressor=int8_quantize``), the data
pipeline (``SyntheticLM``, ``Prefetcher``, ``make_batch_specs``) and the
launcher (``launch/train.py --smoke --device cpu``, checkpoints and
resume).

Both packages start from the JAX package's parameters and optimizer state,
carried across with ``models.weights.params_from_numpy``; the JAX steps run
jitted. Everything runs at smoke size in float32 on the CPU, where the
port's kernels take their plain versions.

Tolerances: the schedule, the norm and one AdamW update given the same
gradients within 1e-6 relative (float32 arithmetic in the reference's
order); a train step's loss and grad_norm within 1e-5 relative; parameters
after one or two steps within 2 lr absolute: AdamW's first steps move each
entry by about lr whatever its gradient's size, so a near-zero gradient
whose sign round-off flips moves it the other way.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke as jget_smoke
from repro.dist.compression import int8_quantize as jint8_quantize
from repro.models import Model as JModel
from repro.models import init_params as jinit_params
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import SyntheticLM as JSyntheticLM
from repro.train import init_opt_state as jinit_opt_state
from repro.train import make_train_step as jmake_train_step
from repro.train import restore_checkpoint as jrestore_checkpoint
from repro.train.data import make_batch_specs as jmake_batch_specs
from repro.train.optimizer import adamw_update as jadamw_update
from repro.train.optimizer import global_norm as jglobal_norm
from repro.train.optimizer import lr_schedule as jlr_schedule
from repro_torch.configs import get_smoke
from repro_torch.dist.compression import _flatten, int8_quantize
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.models.weights import params_from_numpy
from repro_torch.train import (AdamWConfig, Prefetcher, SyntheticLM,
                               adamw_update, global_norm, init_opt_state,
                               lr_schedule, make_batch_specs,
                               make_train_step, save_checkpoint)

CPU = torch.device("cpu")
OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=50)


def carry(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device=CPU)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 20, 100, 10_000])
@pytest.mark.parametrize("cfg", [dict(), dict(warmup_steps=20,
                                              decay_steps=100)])
def test_lr_schedule_vs_jax(step, cfg):
    want = float(jlr_schedule(JAdamWConfig(**cfg), jnp.int32(step)))
    got = lr_schedule(AdamWConfig(**cfg), torch.tensor(step,
                                                       dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(float(lr_schedule(AdamWConfig(**cfg), step)),
                               want, rtol=1e-6)


def one_tree(seed):
    """A parameter tree with leaves of 0 to 3 dimensions (weight decay on
    two and more), and gradients of its shapes."""
    rng = np.random.default_rng(seed)
    shapes = dict(a=(3, 5), b=dict(c=(7,), d=(2, 3, 4)), e=())
    def draw(s):
        return {k: draw(v) if isinstance(v, dict)
                else rng.standard_normal(v).astype(np.float32)
                for k, v in s.items()}
    return draw(shapes), draw(shapes)


def test_global_norm_and_adamw_update_vs_jax():
    """Three updates of one tree with the reference's gradients (a large
    one first, so clipping scales it): parameters, m, v, step, grad_norm
    and lr within 1e-6 relative; the update works in place."""
    p_np, _ = one_tree(0)
    cfg = dict(lr=1e-2, warmup_steps=1, decay_steps=10)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = jinit_opt_state(jp)
    tp, ts = carry(jp), carry(js)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for i in range(3):
        _, g_np = one_tree(10 + i)
        if i == 0:
            g_np = jax.tree.map(lambda x: 10 * x, g_np)
        jg = jax.tree.map(jnp.asarray, g_np)
        np.testing.assert_allclose(float(global_norm(carry(jg))),
                                   float(jglobal_norm(jg)), rtol=1e-6)
        jp, js, jm = jadamw_update(jp, jg, js, JAdamWConfig(**cfg))
        leaf = tp["a"]
        tp, ts, tm = adamw_update(tp, carry(jg), ts, AdamWConfig(**cfg))
        assert tp["a"] is leaf                       # in place
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for got, want in zip(_flatten([tp, ts["m"], ts["v"]]),
                             jax.tree.leaves([jp, js["m"], js["v"]])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-9)


def test_adamw_on_quadratic():
    """AdamW minimizes a quadratic (the reference's sanity test)."""
    p = {"w": torch.tensor([5.0, -3.0])}
    st = init_opt_state(p)
    cfg = AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                      decay_steps=10**6, min_lr_frac=1.0)
    for _ in range(200):
        p, st, _ = adamw_update(p, {"w": 2 * p["w"]}, st, cfg)
    assert float(p["w"].abs().max()) < 1e-2


def test_update_slices_a_large_leaf(monkeypatch):
    """A leaf longer than ``SLICE`` is updated slice by slice, with the
    same numbers as in one piece."""
    from repro_torch.train import optimizer
    rng = np.random.default_rng(3)
    p = {"w": torch.as_tensor(rng.standard_normal((10, 7)), dtype=torch.float32)}
    g = {"w": torch.as_tensor(rng.standard_normal((10, 7)), dtype=torch.float32)}
    whole = adamw_update({"w": p["w"].clone()}, g, init_opt_state(p),
                         AdamWConfig())[0]["w"]
    monkeypatch.setattr(optimizer, "SLICE", 16)
    sliced = adamw_update({"w": p["w"].clone()}, g, init_opt_state(p),
                          AdamWConfig())[0]["w"]
    assert torch.equal(whole, sliced)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

_JAX_STEPS = {}


def jax_step(arch, accum=1, compress=False):
    key = (arch, accum, compress)
    if key not in _JAX_STEPS:
        jcfg = jget_smoke(arch).scaled(dtype="float32")
        _JAX_STEPS[key] = jax.jit(jmake_train_step(
            JModel(jcfg), JAdamWConfig(**OPT), accum=accum,
            compressor=jint8_quantize if compress else None))
    return _JAX_STEPS[key]


def run_both(arch, steps, accum=1, compress=False, batch=4, seq=16):
    jcfg = jget_smoke(arch).scaled(dtype="float32")
    tcfg = get_smoke(arch).scaled(dtype="float32")
    jp = jinit_params(jcfg, seed=0)
    js = jinit_opt_state(jp)
    tp, ts = carry(jp), carry(js)
    jfn = jax_step(arch, accum, compress)
    tfn = make_train_step(Model(tcfg), AdamWConfig(**OPT), accum=accum,
                          compressor=int8_quantize if compress else None)
    jdata = JSyntheticLM(jcfg.vocab, seq, batch, seed=1)
    tdata = SyntheticLM(tcfg.vocab, seq, batch, seed=1)
    out = []
    for step in range(steps):
        jp, js, jm = jfn(jp, js, jax.tree.map(jnp.asarray,
                                              jdata.batch_at(step)))
        tp, ts, tm = tfn(tp, ts, tdata.batch_at(step))
        out.append((jm, tm))
    return (jp, js), (tp, ts), out


def assert_step_close(jax_state, port_state, metrics):
    for jm, tm in metrics:
        for k in ("loss", "grad_norm", "nll", "aux", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-8)
            assert tm[k].dim() == 0
    (jp, js), (tp, ts) = jax_state, port_state
    assert int(ts["step"]) == int(js["step"])
    for got, want in zip(_flatten(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2 * OPT["lr"])


@pytest.mark.parametrize("arch,steps", [("granite-3-2b", 1),
                                        ("granite-3-2b", 2),
                                        ("qwen2-moe-a2.7b", 2),
                                        ("mamba2-2.7b", 1)])
def test_train_steps_vs_jax(arch, steps):
    j, t, metrics = run_both(arch, steps)
    assert_step_close(j, t, metrics)


def test_accum_2_vs_jax_and_vs_accum_1():
    """``accum=2``: against the reference's scan, and its loss and
    grad_norm against one step over the whole batch (every label counts, so
    the microbatches' mean NLL is the whole batch's)."""
    j, t, metrics = run_both("granite-3-2b", 1, accum=2)
    assert_step_close(j, t, metrics)
    _, _, whole = run_both("granite-3-2b", 1)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[0][1][k]),
                                   float(whole[0][1][k]), rtol=1e-5)


def test_int8_compressor_vs_jax():
    j, t, metrics = run_both("granite-3-2b", 1, compress=True)
    assert_step_close(j, t, metrics)


def test_opt_state_checkpoint_restores_in_jax(tmp_path):
    """The port's (params, opt) written by its checkpoint module restores
    in the JAX package, bitwise, the step counter included."""
    jcfg = jget_smoke("granite-3-2b").scaled(dtype="float32")
    jp = jinit_params(jcfg, seed=0)
    js = jinit_opt_state(jp)
    (_, _), (tp, ts), _ = run_both("granite-3-2b", 1)
    save_checkpoint(str(tmp_path), 1, (tp, ts))
    (rp, rs), step = jrestore_checkpoint(str(tmp_path), (jp, js))
    assert step == 1 and int(rs["step"]) == 1
    for got, want in zip(jax.tree.leaves((rp, rs)), _flatten((tp, ts))):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())


# --------------------------------------------------------------------------
# the data pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step", [(0, 0), (5, 7), (11, 12345)])
def test_synthetic_lm_bitwise_vs_jax(seed, step):
    want = JSyntheticLM(300, 24, 3, seed=seed).batch_at(step)
    got = SyntheticLM(300, 24, 3, seed=seed).batch_at(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_prefetcher():
    src = SyntheticLM(256, 16, 2, seed=6)
    pf = Prefetcher(src, start_step=3)
    b = pf.next()
    assert torch.equal(b["tokens"], src.batch_at(3)["tokens"])
    pf.close()


def test_prefetcher_relays_worker_exception():
    """A source that dies surfaces its exception in next(), after the
    batches queued before the failure, in order."""
    class Dies:
        def __init__(self):
            self.good = SyntheticLM(256, 16, 2, seed=7)

        def batch_at(self, step):
            if step >= 2:
                raise OSError("shard server went away")
            return self.good.batch_at(step)

    pf = Prefetcher(Dies(), depth=1)
    got = [pf.next(), pf.next()]
    assert torch.equal(got[0]["tokens"], Dies().good.batch_at(0)["tokens"])
    with pytest.raises(OSError, match="shard server went away"):
        pf.next()
    pf.close()


def test_prefetcher_close_joins_blocked_worker():
    """close() drains while joining, so a worker blocked re-filling a
    depth-1 queue is reaped."""
    pf = Prefetcher(SyntheticLM(256, 16, 2, seed=8), depth=1)
    pf.next()
    assert pf.close() is True
    assert not pf.t.is_alive()


def test_prefetcher_close_warns_on_stuck_source():
    """A worker stuck inside source.batch_at cannot be reaped: close() says
    so with a RuntimeWarning and returns False."""
    release = threading.Event()

    class Hangs:
        def batch_at(self, step):
            release.wait()
            return {"tokens": torch.zeros((2, 16), dtype=torch.int32)}

    pf = Prefetcher(Hangs(), depth=1)
    try:
        with pytest.warns(RuntimeWarning, match="still alive"):
            assert pf.close(timeout=0.3) is False
    finally:
        release.set()
        pf.t.join(timeout=5.0)
    assert not pf.t.is_alive()


@pytest.mark.parametrize("arch", ["granite-3-2b", "hubert-xlarge",
                                  "qwen2-vl-7b"])
def test_make_batch_specs_vs_jax(arch):
    shape = dict(batch=3, seq=20)
    want = jmake_batch_specs(jget_smoke(arch), shape)
    got = make_batch_specs(get_smoke(arch), shape)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec.shape)
        assert str(got[k].dtype).split(".")[-1] == spec.dtype.name


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

ARGS = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu", "--seq",
        "32", "--batch", "4"]


def test_launcher_smoke_lowers_the_loss(capsys):
    _, _, losses = launch_train.main(ARGS + ["--steps", "30"])
    assert len(losses) == 30 and losses[-1] < losses[0]
    assert "step    29 loss" in capsys.readouterr().out


def test_launcher_without_smoke_names_what_waits():
    with pytest.raises(NotImplementedError, match="launch/dryrun.py"):
        launch_train.main(["--arch", "granite-3-2b", "--device", "cpu"])


def test_launcher_resume_is_bitwise(tmp_path, monkeypatch):
    """A run whose data source dies at step 4 (after the checkpoint of step
    3), resumed by a second launch from the same directory, ends bitwise
    where an uninterrupted run ends."""
    base = ARGS + ["--steps", "6", "--ckpt-every", "3"]
    p_ref, o_ref, l_ref = launch_train.main(
        base + ["--ckpt-dir", str(tmp_path / "a")])

    class Dies(SyntheticLM):
        def batch_at(self, step):
            if step >= 4:
                raise OSError("killed")
            return super().batch_at(step)

    ck = str(tmp_path / "b")
    monkeypatch.setattr(launch_train, "SyntheticLM", Dies)
    with pytest.raises(OSError, match="killed"):
        launch_train.main(base + ["--ckpt-dir", ck])
    monkeypatch.setattr(launch_train, "SyntheticLM", SyntheticLM)
    p, o, losses = launch_train.main(base + ["--ckpt-dir", ck])
    assert losses == l_ref[3:]
    for a, b in zip(_flatten((p, o)), _flatten((p_ref, o_ref))):
        assert torch.equal(a, b)
