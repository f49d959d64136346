"""Gradients of the port against the JAX package's.

``Model.loss`` and every gradient leaf of the port (``train.value_and_grad``:
torch.autograd through the plain versions of the kernels, on the CPU)
against ``jax.value_and_grad`` of ``repro``'s ``Model.loss`` (jitted), from
the JAX package's own parameters carried across, on the same batch
(``synthetic_batch`` draws it the same in both packages), in float32 at each
architecture's smoke config: granite (GQA), qwen2-moe (MoE), deepseek-v2-lite
(MLA, d != dv), hubert (the encoder branch; its ``embed`` leaf gets zeros in
both), qwen2-vl (``pos3``), mamba2 (the SSD scan: autograd through
``ssd_chunk``'s plain version on the CPU, its backward kernel on the card)
and jamba (the hybrid: mamba and attention layers, MoE every other layer).

Tolerances: the loss within 1e-6 relative; each gradient leaf within 1e-5 of
its own largest |g| (two float32 summation orders through softmax, the
router and two layers; the largest deviation seen is 3.9e-6). jamba's smoke
config has eight layers, and through them the float32 gradients of its SSD
decay leaves are noisier than 1e-5 in both packages: against the JAX
package's own float64 gradients, its float32 ones part by up to 2.5e-5 of
the leaf's largest |g| (``A_log`` of the last mamba layer) and the port's
by up to 2.2e-5; the two float32 runs part by up to 3.8e-5. jamba's leaves
are held within 1e-4.

The kernels' refusals on the card (a CUDA kernel with no backward raises on
a call that needs a gradient) are ``gpu`` tests and skip here.
"""
import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke as jget_smoke
from repro.models import Model as JModel
from repro.models import init_params as jinit_params
from repro.train.data import synthetic_batch as jsynthetic_batch
from repro_torch.configs import get_smoke
from repro_torch.dist.compression import _flatten, _unflatten
from repro_torch.kernels import refuse_grad
from repro_torch.models import Model
from repro_torch.models.weights import params_from_numpy
from repro_torch.train import synthetic_batch, value_and_grad

ARCHS = ("granite-3-2b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
         "hubert-xlarge", "qwen2-vl-7b", "mamba2-2.7b",
         "jamba-1.5-large-398b")
SHAPE = dict(batch=2, seq=16)
LEAF_TOL = {"jamba-1.5-large-398b": 1e-4}     # else 1e-5 (the docstring)
CPU = torch.device("cpu")


def setup_arch(arch):
    jcfg = jget_smoke(arch).scaled(dtype="float32")
    tcfg = get_smoke(arch).scaled(dtype="float32")
    jp = jinit_params(jcfg, seed=0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    return jcfg, tcfg, jp, tp


def assert_leaves_close(got, want, frac=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=frac * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_vs_jax(arch):
    jcfg, tcfg, jp, tp = setup_arch(arch)
    jb = jsynthetic_batch(jcfg, SHAPE, seed=3)
    tb = synthetic_batch(tcfg, SHAPE, seed=3, device=CPU)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JModel(jcfg).loss,
                                              has_aux=True))(jp, jb)
    tl, tm, tg = value_and_grad(Model(tcfg), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("nll", "aux", "ntok"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   atol=1e-7)
    assert_leaves_close(_flatten(tg), jax.tree.leaves(jg),
                        LEAF_TOL.get(arch, 1e-5))
    if tcfg.kind == "encoder":           # the frontend never reads embed
        assert not bool(tg["embed"].any())
        assert not np.asarray(jg["embed"]).any()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_remat_gives_equal_gradients(arch):
    """``forward(remat=True)`` recomputes each period in the backward pass
    (``torch.utils.checkpoint``): the logits' gradients are those of
    remat=False, bitwise (the same operations on the same inputs). jamba's
    period holds several layers of both kinds."""
    from repro_torch.models import init_params
    cfg = get_smoke(arch).scaled(dtype="float32")
    model = Model(cfg)
    params = init_params(cfg, seed=1, device=CPU)
    batch = synthetic_batch(cfg, SHAPE, seed=4, device=CPU)
    leaves = _flatten(params)
    weight = torch.randn(SHAPE["seq"], 1, generator=torch.Generator()
                         .manual_seed(0))
    grads = []
    for remat in (True, False):
        live = [p.clone().requires_grad_() for p in leaves]
        logits, aux, _ = model(_unflatten(params, live), batch, remat=remat)
        out = (logits * weight).sum() + aux
        grads.append(torch.autograd.grad(out, live, allow_unused=True))
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_refuse_grad_only_when_a_gradient_is_needed():
    x = torch.ones(3)
    refuse_grad("k", "why", x)                 # nothing requires grad
    y = x.clone().requires_grad_()
    with torch.no_grad():
        refuse_grad("k", "why", y)             # grad mode off
    with pytest.raises(RuntimeError, match="k's CUDA kernel has no backward "
                       r"\(why\)"):
        refuse_grad("k", "why", x, y)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_without_backward_refuse_on_gpu(cuda):
    """On the card ``segment_reduce`` and ``semiring_matmul`` raise on a
    call that needs a gradient, and run under no_grad. (``ssd_chunk``
    carries its gradient since its backward kernel:
    ``tests/test_torch_ssd_chunk.py``'s gpu tests.)"""
    from repro_torch.kernels import segreduce, semiring_matmul
    g = torch.Generator(device=cuda).manual_seed(0)
    vals = torch.randn(64, generator=g, device=cuda).requires_grad_()
    ids = torch.arange(64, device=cuda) // 8
    with pytest.raises(RuntimeError, match="segreduce"):
        segreduce.segment_reduce(vals, ids, 8, "sum")
    with torch.no_grad():
        segreduce.segment_reduce(vals, ids, 8, "sum")
    a = torch.randn(8, 8, generator=g, device=cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="semiring_matmul"):
        semiring_matmul.semiring_matmul(a, a.detach())
    with torch.no_grad():
        semiring_matmul.semiring_matmul(a, a.detach())


@pytest.mark.gpu
def test_train_step_on_gpu_matches_cpu(cuda):
    """One ``make_train_step`` step of qwen2-moe at smoke size in float32 on
    the card (kernels and their backward kernels) and on the CPU (plain
    versions): loss and grad_norm within 1e-5 relative, parameters within
    2 lr."""
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    cfg = get_smoke("qwen2-moe-a2.7b").scaled(dtype="float32")
    model = Model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    out = {}
    for dev in (CPU, cuda):
        p = _to(init_params(cfg, seed=0, device=CPU), dev)
        step = make_train_step(model, opt_cfg)
        b = synthetic_batch(cfg, SHAPE, seed=2, device=dev)
        p, _, m = step(p, init_opt_state(p), b)
        out[dev.type] = (_flatten(p), float(m["loss"]), float(m["grad_norm"]))
    (pc, lc, gc), (pg, lg, gg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=1e-5)
    for a, b in zip(pg, pc):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=2e-3)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
