"""The port's training loss and gradients (``transformer.loss_fn`` under
autograd) against the reference's ``jax.value_and_grad`` of its
``loss_fn``, on the smoke configuration of every architecture
(``check_supported`` passes all ten), from the reference's parameters
with every leaf moved by 0.02 N(0, 1) from a seed (so zero-initialised
norms, LoRA-b matrices and RWKV's ``u`` carry gradients of their own),
on a synthetic batch of 2 x 16 tokens.

Bounds (float32 compute): the loss within 1e-5 (measured on the CPU:
4.8e-7), the MoE auxiliary loss within 1e-5 of its value (2e-7), and
every gradient leaf within 1e-5 of the leaf's largest magnitude
(measured 1.8e-6, recurrentgemma; the summation order of the products and of the RG-LRU and attention plain versions
against the reference's associative-scan and XLA forms), rwkv6's within
1e-4 (measured 6.8e-5, against the reference's chunked WKV and its
step-by-step one alike: moving every parameter by one float32 ulp moves
the port's own rwkv6 gradients by 6.5e-5, and the reference's two WKV
forms lie 3.7e-6 apart).  A leaf the loss does not reach has no
gradient in the port only where the reference's is zero everywhere (the empty ``q_norm``/``k_norm`` without qk-norm).  Then the
loss and every gradient are bitwise equal under ``remat`` none, dots and
full.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.models import transformer as jt
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import convert, transformer as tt

LOSS_TOL = 1e-5
GRAD_TOL = {"rwkv6-3b": 1e-4}
GRAD_TOL_DEFAULT = 1e-5
SEQ, BATCH = 16, 2


def _perturbed_params(jcfg):
    p = jt.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(np.asarray(a, np.float32)
                             + 0.02 * rng.normal(size=a.shape), np.float32),
        p)


def _port_grads(cfg, params, batch):
    named = dict(params.named_parameters())
    loss, aux = tt.loss_fn(cfg, params, batch)
    got = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, dict(
        zip(named, got))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_every_gradient_match_reference(arch):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    tt.check_supported(cfg)
    ref = _perturbed_params(jcfg)
    batch = host_batch(jcfg, DataConfig(SEQ, BATCH, seed=0), 0)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jcfg, p, b), has_aux=True))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    params = tt.trainable(convert.params_from_numpy(cfg, ref))
    loss, aux, grads = _port_grads(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= LOSS_TOL
    assert abs(float(aux["ce"]) - float(jaux["ce"])) <= LOSS_TOL
    assert abs(float(aux["moe_aux_loss"]) - float(jaux["moe_aux_loss"])) <= (
        LOSS_TOL * max(1.0, abs(float(jaux["moe_aux_loss"]))))

    groups = convert.leaf_groups(cfg, params)
    want = convert.flat_tree(jax.tree_util.tree_map(np.asarray, jg))
    assert list(want) == list(groups)
    missing = [k for k, names in groups.items()
               if any(grads[n] is None for n in names)]
    for k in missing:
        assert not np.any(want[k]), f"{k}: no port gradient, reference's " \
                                    f"is not zero"
    filled = {n: torch.zeros_like(p) if grads[n] is None else grads[n]
              for n, p in params.named_parameters()}
    got = convert.tree_from_named(groups, filled)
    for k in want:
        scale = max(float(np.abs(want[k]).max(initial=0.0)), 1e-30)
        err = float(np.abs(got[k] - want[k]).max(initial=0.0))
        assert err <= GRAD_TOL.get(arch, GRAD_TOL_DEFAULT) * scale, (
            k, err, scale)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_remat_modes_give_bitwise_equal_loss_and_gradients(arch):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    params = tt.trainable(convert.params_from_numpy(
        cfg, _perturbed_params(jcfg)))
    batch = {k: torch.from_numpy(v) for k, v in
             host_batch(jcfg, DataConfig(SEQ, BATCH, seed=1), 0).items()}
    runs = {r: _port_grads(cfg.replace(remat=r), params, batch)
            for r in ("none", "dots", "full")}
    loss0, aux0, g0 = runs["none"]
    for remat, (loss, aux, g) in runs.items():
        assert torch.equal(loss, loss0), remat
        assert all(torch.equal(aux[k], aux0[k]) for k in aux0), remat
        for k in g0:
            assert (g[k] is None) == (g0[k] is None), (remat, k)
            if g0[k] is not None:
                assert torch.equal(g[k], g0[k]), (remat, k)
