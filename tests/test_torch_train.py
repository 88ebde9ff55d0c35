"""The port's training path against the reference's: the train step
(``repro_torch.launch.steps``) over three steps from the reference's own
train state, the launcher (``repro_torch.launch.train``) killed and
resumed from its checkpoints, bfloat16 parameters through a checkpoint,
the kernels' gradient wrapper, the prefetch pipeline, the fault helpers
and the cases of ``tests/test_archs_smoke.py`` on the port.

Bounds: three ``make_train_step`` steps from the reference's state and
batches give each step's loss, cross-entropy and MoE auxiliary loss
within 1e-5 of the reference's (relative above 1) and its ``grad_norm``
within 1e-5 relative (measured on the CPU: 1.9e-7 and 3.0e-7), and the
parameters and optimizer moments after them within 1e-5 of each leaf's
largest magnitude (measured 3.3e-6).  Under int8 compression a gradient that
lies within its float32 gap of a rounding boundary rounds to the next
int8 level (a discontinuity: the compressor itself is bitwise the
reference's on equal inputs, ``tests/test_torch_optim.py``), so there the
moments are held within one level, 1/127 of each leaf's largest
magnitude (measured 8.6e-4 after three steps), and the residuals within
one quantization step, twice their largest magnitude (measured 1.36
after the first step, 0.20 after three); the parameters stay within
1e-5 (6.6e-7).  The resumed launcher's losses and final checkpoint are
bitwise the uninterrupted run's; the gradient wrapper is bitwise
autodiff of the plain version it recomputes.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.data.synthetic import DataConfig, host_batch
from repro.launch import steps as j_steps
from repro.optim import compress as j_compress
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.data.pipeline import PrefetchIterator
from repro_torch.data.synthetic import batch_iterator
from repro_torch.distributed.fault import HeartbeatMonitor, StragglerDetector
from repro_torch.kernels.autograd import with_ref_grad
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe_gmm.ref import gmm_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rwkv6_scan import ops as rw_ops
from repro_torch.launch import steps, train
from repro_torch.models import convert, transformer as tt

STEP_TOL = 1e-5
STATE_TOL = 1e-5
LEVEL_TOL = 1.0 / 127.0   # one int8 level of a gradient block
EF_TOL = 2.0              # one quantization step: twice the largest |r|


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------- train step ----
@pytest.mark.parametrize("arch,compress", [
    ("qwen3-8b", False), ("qwen3-8b", True), ("arctic-480b", False),
    ("qwen2-vl-2b", False), ("granite-moe-3b-a800m", False)])
def test_train_step_matches_reference_for_three_steps(arch, compress):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jstate = j_steps.make_train_state(jcfg, jax.random.PRNGKey(0))
    if compress:
        jstate["ef"] = j_compress.init_ef(jstate["params"])
    state = convert.train_state_from_numpy(cfg, _np(jstate))
    jstep = jax.jit(j_steps.make_train_step(jcfg, grad_compress=compress,
                                            total_steps=3))
    step = steps.make_train_step(cfg, grad_compress=compress, total_steps=3)
    for i in range(3):
        batch = host_batch(jcfg, DataConfig(16, 2, seed=0), i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        assert sorted(m) == sorted(jm)
        for k in ("loss", "ce", "moe_aux_loss"):
            assert abs(float(m[k]) - float(jm[k])) <= STEP_TOL * max(
                1.0, abs(float(jm[k]))), (i, k)
        if "grad_norm" in jm:
            assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= (
                STEP_TOL * float(jm["grad_norm"]))
    want = convert.flat_tree(_np(jstate))
    got = convert.flat_tree(convert.train_state_to_numpy(cfg, state))
    assert sorted(got) == sorted(want)
    for k in want:
        a = np.asarray(want[k], np.float32)
        err = float(np.abs(got[k] - a).max(initial=0.0))
        tol = STATE_TOL
        if compress and not k.startswith("params."):
            tol = EF_TOL if k.startswith("ef.") else LEVEL_TOL
        assert err <= tol * max(float(np.abs(a).max(initial=0.0)),
                                1e-30), (k, err)


# ------------------------------------------------ launcher, checkpoints ----
def _final_state(directory):
    mgr = CheckpointManager(directory)
    import json
    step = mgr.latest_step()
    with open(os.path.join(directory, f"step_{step:08d}",
                           ckpt.MANIFEST)) as f:
        keys = [e["key"] for e in json.load(f)["leaves"]]
    out = {}
    for key in keys:
        entry = os.path.join(directory, f"step_{step:08d}",
                             ckpt._fname(key))
        out[key] = np.load(entry)
    return step, out


@pytest.mark.parametrize("arch,extra", [("qwen3-8b", []),
                                        ("arctic-480b", ["--compress"])])
def test_killed_and_resumed_training_is_bitwise_uninterrupted(
        tmp_path, monkeypatch, arch, extra):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--log-every", "1"] + extra
    whole = train.main(args + ["--ckpt-dir", str(tmp_path / "whole")])

    class Killed(Exception):
        pass

    real = steps.make_train_step

    def dying(*a, **kw):
        step, calls = real(*a, **kw), [0]

        def run(state, batch, *hooks):
            calls[0] += 1
            if calls[0] == 4:
                raise Killed()
            return step(state, batch, *hooks)
        return run

    monkeypatch.setattr(train.steps_lib, "make_train_step", dying)
    monkeypatch.setattr(train, "CheckpointManager", functools.partial(
        CheckpointManager, async_write=False))
    with pytest.raises(Killed):
        train.main(args + ["--ckpt-dir", str(tmp_path / "cut")])
    monkeypatch.setattr(train.steps_lib, "make_train_step", real)
    assert CheckpointManager(str(tmp_path / "cut")).latest_step() == 2
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "cut"),
                                 "--resume"])
    assert resumed == whole[2:]
    step_a, a = _final_state(str(tmp_path / "whole"))
    step_b, b = _final_state(str(tmp_path / "cut"))
    assert step_a == step_b == 6 and sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if extra:
        assert any(k.startswith("ef.residual.") for k in a)
        assert any(k.startswith("opt.v.") for k in a)


def test_bfloat16_parameters_round_trip_bitwise(tmp_path):
    cfg = smoke_config("qwen3-8b").replace(param_dtype="bfloat16")
    state = steps.make_train_state(cfg, 0, "cpu")
    assert all(p.dtype == torch.bfloat16
               for p in state["params"].parameters())
    batch = {k: torch.from_numpy(v) for k, v in
             host_batch(cfg, DataConfig(16, 2, seed=0), 0).items()}
    state, m = steps.make_train_step(cfg)(state, batch)
    assert np.isfinite(float(m["loss"]))
    mgr = CheckpointManager(str(tmp_path / "ck"), async_write=False)
    mgr.save(1, steps.state_tree(state))
    fresh = steps.make_train_state(cfg, 1, "cpu")
    back = steps.load_state_tree(fresh, mgr.restore(steps.state_tree(fresh)))
    for (k, p), (_, q) in zip(state["params"].named_parameters(),
                              back["params"].named_parameters()):
        assert q.dtype == torch.bfloat16 and torch.equal(
            p.view(torch.int16), q.view(torch.int16)), k
    for k, a in state["opt"].mu.items():
        assert torch.equal(a, back["opt"].mu[k]), k
    import json
    with open(tmp_path / "ck" / "step_00000001" / ckpt.MANIFEST) as f:
        dtypes = {e["key"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes["params.embed"] == "bfloat16"
    assert dtypes["opt.mu.embed"] == "float32"


def test_bfloat16_reference_state_converts_bitwise():
    jcfg = j_smoke("arctic-480b").replace(param_dtype="bfloat16")
    cfg = smoke_config("arctic-480b").replace(param_dtype="bfloat16")
    jstate = _np(j_steps.make_train_state(jcfg, jax.random.PRNGKey(0)))
    state = convert.train_state_from_numpy(cfg, jstate)
    assert all(p.dtype == torch.bfloat16
               for p in state["params"].parameters())
    want = convert.flat_tree(jstate["params"])
    got = convert.flat_tree(convert.train_state_to_numpy(cfg, state)[
        "params"])
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k],
                                                         np.float32))


# ------------------------------------------------- the gradient wrapper ----
def _gmm_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 8, 5), generator=g, requires_grad=True)
    w = torch.randn((3, 5, 4), generator=g, requires_grad=True)
    sizes = torch.tensor([[8, 3, 0], [1, 8, 5]], dtype=torch.int32)
    return (x, w, sizes), lambda out: (out * out).sum()


def _attention_inputs():
    g = torch.Generator().manual_seed(1)
    mk = lambda *s: torch.randn(s, generator=g, requires_grad=True)
    q, k, v = mk(2, 6, 4, 8), mk(2, 6, 2, 8), mk(2, 6, 2, 8)
    return (q, k, v), lambda out: (out * out).sum()


def _rwkv_inputs(s0):
    g = torch.Generator().manual_seed(2)
    mk = lambda *s: torch.randn(s, generator=g, requires_grad=True)
    r, k, v = mk(1, 2, 16, 4), mk(1, 2, 16, 4), mk(1, 2, 16, 4)
    logw = (-torch.rand((1, 2, 16, 4), generator=g)).requires_grad_(True)
    u = mk(2, 4)
    state = mk(1, 2, 4, 4) if s0 else None
    return ((r, k, v, logw, u, state),
            lambda out: (out[0] ** 2).sum() + (out[1] ** 3).sum())


def _rglru_inputs():
    g = torch.Generator().manual_seed(3)
    log_a = (-torch.rand((2, 9, 5), generator=g)).requires_grad_(True)
    b = torch.randn((2, 9, 5), generator=g, requires_grad=True)
    return (log_a, b), lambda out: (out[0] ** 2).sum() + out[1].sum()


@pytest.mark.parametrize("case", ["gmm", "attention", "rwkv", "rwkv_s0",
                                  "rglru"])
def test_kernel_gradient_wrapper_is_autodiff_of_plain(case):
    """The wrapper's backward recomputes the plain version: with the plain
    version standing in for the kernel (a kernel runs only on the card),
    its gradients are bitwise those of autodiff through the plain version,
    for tuple outputs, None and integer inputs alike; a checkpointed
    forward launches it again."""
    plain = {"gmm": gmm_ref,
             "attention": functools.partial(fa_ops._plain, causal=True,
                                            window=3, softcap=0.0),
             "rwkv": rw_ops._plain, "rwkv_s0": rw_ops._plain,
             "rglru": rg_ops._plain}[case]
    inputs, loss_of = {"gmm": _gmm_inputs, "attention": _attention_inputs,
                       "rwkv": lambda: _rwkv_inputs(False),
                       "rwkv_s0": lambda: _rwkv_inputs(True),
                       "rglru": _rglru_inputs}[case]()
    diff = [x for x in inputs if x is not None and x.requires_grad]
    want = torch.autograd.grad(loss_of(plain(*inputs)), diff)
    calls = [0]

    def launch(*t):
        calls[0] += 1
        with torch.no_grad():
            return plain(*t)

    out = with_ref_grad(launch, plain, *inputs)
    assert not isinstance(out, tuple) or all(o.requires_grad for o in out)
    got = torch.autograd.grad(loss_of(out), diff)
    assert calls == [1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out = torch.utils.checkpoint.checkpoint(
        lambda *t: with_ref_grad(launch, plain, *t), *inputs,
        use_reentrant=False)
    got = torch.autograd.grad(loss_of(out), diff)
    assert calls == [3]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        with_ref_grad(launch, plain, *inputs)
    assert calls == [4]


# ----------------------------------------------------- pipeline, faults ----
def test_prefetch_iterator_preserves_order():
    cfg = smoke_config("qwen2-vl-2b")
    it = PrefetchIterator(batch_iterator(cfg, DataConfig(8, 2, seed=0)),
                          depth=2, device="cpu")
    ref = batch_iterator(cfg, DataConfig(8, 2, seed=0))
    for _ in range(5):
        a, b = next(it), next(ref)
        assert sorted(a) == sorted(b)
        for k in b:
            assert torch.is_tensor(a[k])
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_prefetch_iterator_surfaces_errors_and_ends():
    def bad():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise ValueError("source failed")

    it = PrefetchIterator(bad())
    assert next(it)["tokens"].shape == (1, 2)
    with pytest.raises(ValueError, match="source failed"):
        next(it)
    it = PrefetchIterator(iter([{"tokens": np.zeros(1)}]))
    assert list(it)[0]["tokens"].shape == (1,)


def test_heartbeat_failure_detection():
    mon = HeartbeatMonitor(n_workers=3, timeout=10.0)
    mon.beat(0, now=100.0)
    mon.beat(1, now=105.0)
    assert set(mon.failed_workers(now=111.0)) == {0, 2}


def test_straggler_detection():
    det = StragglerDetector(threshold=1.5, window=10)
    for _ in range(10):
        for w in range(4):
            det.record(w, 1.0 if w != 2 else 2.5)
    assert det.stragglers() == [2]
    assert StragglerDetector().stragglers() == []


# ----------------------------------- tests/test_archs_smoke.py, the port ----
def _batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_codebooks, s) if cfg.n_codebooks else (b, s)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, shape)).to(
        torch.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["vision_embeds"] = 0.1 * torch.ones(
            (b, cfg.vision_tokens, cfg.vision_dim))
        batch["mrope_positions"] = torch.arange(s).view(1, 1, s).repeat(
            3, b, 1)
    return batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_train_step_finite(arch):
    cfg = smoke_config(arch)
    state = steps.make_train_state(cfg, 0, "cpu")
    state, m = steps.make_train_step(cfg)(state, _batch(cfg))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["loss"]) >= 0.0
    for p in state["params"].parameters():
        assert bool(torch.isfinite(p).all())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_decode_matches_training_forward(arch):
    """The serving path's prefill and decode reproduce the training
    forward's logits (MoE dropless: capacity drops are a training
    matter), within the reference test's 2e-4."""
    cfg = smoke_config(arch)
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=100.0)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s, pre = 2, 24, 20
    batch = _batch(cfg, b, s)
    with torch.no_grad():
        h, _ = tt.forward(cfg, params, batch)
        full = tt.lm_logits(cfg, params, h)
        pb = dict(batch, tokens=batch["tokens"][..., :pre])
        if cfg.family == "vlm":
            pb["mrope_positions"] = batch["mrope_positions"][..., :pre]
        cache, logits = tt.prefill(cfg, params, pb, max_len=s)
        for t in range(pre, s + 1):
            want = full[..., t - 1, :]
            np.testing.assert_allclose(logits[..., 0, :].numpy(),
                                       want.numpy(), rtol=2e-4, atol=2e-4)
            if t == s:
                break
            db = {"tokens": batch["tokens"][..., t:t + 1]}
            if cfg.family == "vlm":
                db["mrope_positions"] = batch["mrope_positions"][..., t:t + 1]
            cache, logits = tt.decode_step(cfg, params, cache, db, t)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m"])
def test_bfloat16_parameters_match_reference_loss(arch):
    """With ``param_dtype="bfloat16"`` the RWKV and RG-LRU blocks compute
    against their weights promoted to float32, as the reference's float32
    activations promote them: the loss within 1e-5 of the reference's."""
    jcfg = j_smoke(arch).replace(param_dtype="bfloat16")
    cfg = smoke_config(arch).replace(param_dtype="bfloat16")
    jstate = j_steps.make_train_state(jcfg, jax.random.PRNGKey(0))
    state = convert.train_state_from_numpy(cfg, _np(jstate))
    batch = host_batch(jcfg, DataConfig(16, 2, seed=0), 0)
    from repro.models import transformer as jt
    want, _ = jax.jit(lambda p, b: jt.loss_fn(jcfg, p, b))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tt.loss_fn(cfg, state["params"],
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    assert abs(float(got) - float(want)) <= STEP_TOL
