"""The port's Mixture-of-Experts serving path (the grouped expert-matmul
kernel's plain version and dispatch ``repro_torch.kernels.moe_gmm``, the
MoE layer of ``repro_torch.models.mlp``, MoE layers and the tied head in
``repro_torch.models.transformer``) against the reference's, on
granite-moe-3b-a800m's smoke configuration (2 layers, d_model 64, 4 heads
over 2 kv heads of 16, d_ff 32, 4 experts padded to 48, top-2, vocab 128,
tied head), with the reference's own weights (``init_params(cfg,
PRNGKey(0))``) carried across by ``repro_torch.models.convert``.

Tolerances: the grouped matmul against the reference's Pallas kernel (in
interpret mode) at the reference's own (float32 rtol 1e-4, atol 1e-3;
bf16 rtol 5e-2, atol 5e-1; measured on the CPU over its three shapes:
float32 max abs 3.4e-5 at |y| up to 66, bf16 9.8e-4, one bf16 step below
0.5), the two plain versions against each other at rtol = atol = 2e-5
(bf16 at the reference's bf16 tolerance; measured float32 2.1e-5 at |y|
up to 66, a relative 3e-7); the MoE layer's integer routing (expert ids,
sort order, slots, kept assignments, group sizes) and ``drop_frac``
equal, its output and ``aux_loss`` within 1e-5; float32 logits and caches
within 1e-5 absolute (measured 3.0e-7 for the logits, 1.2e-6 for the
caches), every greedy token equal; bf16 logits within 2e-2
(measured 3.9e-3) at each step, decoding the reference's tokens.  The bf16 combine, which adds each token's
contributions in ascending expert order and rounds after each add, is
held bitwise at 40 experts and top-8.  The kernel's ``plan`` (which of
its three bodies a call takes) is held at the serving path's and the
reference test's shapes and at the shapes the tensor-core bodies refuse;
the coverage probe (``ref.probe_inputs``) is exact against the
reference's ``gmm_ref`` and its Pallas kernel, and each fault it is meant
to show changes its product.  The CUDA kernels' own tests against the
plain version and the probe need the card and no JAX, so they live in
``tests/test_torch_cuda.py``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_arch, smoke_config as j_smoke
from repro.kernels.moe_gmm.ops import moe_gmm as j_gmm
from repro.kernels.moe_gmm.ref import gmm_ref as j_gmm_ref
from repro.launch import serve as j_serve
from repro.models import mlp as jm, transformer as jt
from repro_torch.configs import get_arch, smoke_config
from repro_torch.data.synthetic import DataConfig, host_batch
from repro_torch.kernels.moe_gmm import kernel, ops, ref as gmm_probe
from repro_torch.kernels.moe_gmm.ref import gmm_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import convert, mlp as tm, transformer as tt
from test_torch_lm import _as_dicts, _np

ARCH = "granite-moe-3b-a800m"
F32_TOL = 1e-5
BF16_TOL = 2e-2
REF_TOL = dict(rtol=2e-5, atol=2e-5)
# tests/test_kernels.py's grouped-matmul shapes (E, C, D, F), tolerances
# and block sizes
GMM_SHAPES = [(4, 64, 128, 96), (8, 32, 64, 64), (2, 128, 256, 128)]
GMM_TOL = {"float32": dict(rtol=1e-4, atol=1e-3),
           "bfloat16": dict(rtol=5e-2, atol=5e-1)}
GMM_BLOCKS = dict(block_c=32, block_f=32, block_d=64)
PROMPT, GEN, BATCH = 19, 8, 2
MAX_LEN = PROMPT + GEN
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype="float32"):
    return (j_smoke(ARCH).replace(compute_dtype=dtype),
            smoke_config(ARCH).replace(compute_dtype=dtype))


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return jt.init_params(jcfg, jax.random.PRNGKey(0))


def _prompt(cfg, s=PROMPT):
    return host_batch(cfg, DataConfig(s, BATCH, seed=0), 0)["tokens"]


def _gmm_inputs(shape, dtype, seed=0, lead=()):
    """x, w and group sizes in [0, C] from a seed, as numpy (x and w
    rounded to ``dtype``)."""
    e, c, d, f = shape
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]
    rnd = lambda *s: np.asarray(jnp.asarray(rng.normal(size=s), jdt)
                                .astype(jnp.float32))
    return (rnd(*lead, e, c, d), rnd(e, d, f),
            rng.integers(0, c + 1, (*lead, e)).astype(np.int32))


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(DTYPES[dtype][1])


# ------------------------------------------------------- grouped matmul ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GMM_SHAPES)
def test_gmm_ref_matches_reference_ref(shape, dtype):
    x, w, gs = _gmm_inputs(shape, dtype)
    jdt = DTYPES[dtype][0]
    want = j_gmm_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                     jnp.asarray(gs))
    got = gmm_ref(_t(x, dtype), _t(w, dtype), torch.from_numpy(gs))
    assert got.dtype == DTYPES[dtype][1]
    tol = REF_TOL if dtype == "float32" else GMM_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GMM_SHAPES)
def test_ops_matches_pallas_interpret(shape, dtype):
    """``ops.moe_gmm`` on CPU tensors (the plain version) against the
    reference's Pallas kernel run in interpret mode, at
    ``tests/test_kernels.py``'s shapes, tolerances and blocks."""
    x, w, gs = _gmm_inputs(shape, dtype)
    jdt = DTYPES[dtype][0]
    want = np.asarray(j_gmm(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                            jnp.asarray(gs), **GMM_BLOCKS), np.float32)
    got = ops.moe_gmm(_t(x, dtype), _t(w, dtype), torch.from_numpy(gs))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **GMM_TOL[dtype])


@pytest.mark.parametrize("sizes", [[0, 0, 0, 0], [64, 64, 64, 64],
                                   [0, 64, 1, 33], [31, 32, 63, 7]])
def test_ragged_rows_zeroed(sizes):
    """``tests/test_kernels.py:160``'s property: rows at or past a group's
    size are exactly zero; the rows before it equal the Pallas
    kernel's."""
    e, c, d, f = 4, 64, 64, 64
    x, w, _ = _gmm_inputs((e, c, d, f), "float32")
    gs = np.asarray(sizes, np.int32)
    out = ops.moe_gmm(_t(x, "float32"), _t(w, "float32"),
                      torch.from_numpy(gs)).numpy()
    for ei in range(e):
        assert np.all(out[ei, sizes[ei]:, :] == 0.0)
    want = np.asarray(j_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                            **GMM_BLOCKS))
    np.testing.assert_allclose(out, want, **GMM_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_form_matches_reference_row_by_row(dtype):
    """x (B, E, C, D) with sizes (B, E) against the shared w: each batch
    row is the reference's ``gmm_ref`` of that row."""
    shape = (6, 16, 32, 24)
    x, w, gs = _gmm_inputs(shape, dtype, seed=3, lead=(3,))
    got = ops.moe_gmm(_t(x, dtype), _t(w, dtype), torch.from_numpy(gs))
    assert got.shape == (3, 6, 16, 24)
    jdt = DTYPES[dtype][0]
    tol = REF_TOL if dtype == "float32" else GMM_TOL[dtype]
    for b in range(3):
        want = j_gmm_ref(jnp.asarray(x[b], jdt), jnp.asarray(w, jdt),
                         jnp.asarray(gs[b]))
        np.testing.assert_allclose(got[b].float().numpy(),
                                   np.asarray(want, np.float32), **tol)


def test_kernel_wrapper_refuses_cpu_tensors_and_missing_nvcc(
        monkeypatch, tmp_path):
    """The CUDA wrapper takes no CPU tensor (``ops`` sends those to the
    plain version), and the build raises when no ``nvcc`` is found."""
    x, w, gs = _gmm_inputs(GMM_SHAPES[0], "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.moe_gmm(_t(x, "float32"), _t(w, "float32"),
                       torch.from_numpy(gs))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel._load()


def test_build_is_keyed_on_the_shared_headers(monkeypatch, tmp_path):
    """A change to a header of ``kernels/csrc`` (included by K3 and K4 from
    another directory) gives a new build, not the stale library; an
    unchanged one reuses it."""
    from repro_torch.kernels import nvcc
    shared, src = tmp_path / "shared", tmp_path / "k" / "csrc"
    shared.mkdir()
    src.mkdir(parents=True)
    (src / "k.cu").write_text('#include "../../shared/hopper.cuh"\n')
    header = shared / "hopper.cuh"
    header.write_text("// one\n")
    runs = []

    def fake_nvcc(cmd, **kwargs):
        runs.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_text("lib")
        return type("Done", (), {"returncode": 0, "stdout": "",
                                 "stderr": ""})()

    monkeypatch.setattr(nvcc, "SHARED", shared)
    monkeypatch.setattr(nvcc, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(nvcc, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(nvcc.subprocess, "run", fake_nvcc)
    first = nvcc.build(src / "k.cu", "k", nvcc.SM90A)
    assert nvcc.build(src / "k.cu", "k", nvcc.SM90A) == first
    header.write_text("// two\n")
    second = nvcc.build(src / "k.cu", "k", nvcc.SM90A)
    assert second != first and second.exists() and len(runs) == 2


# ------------------------------------- K4's plan and its coverage probe ----
# (x shape, w shape, dtype) -> (body, D slices): the granite serving path's
# prefill and decode products, tests/test_kernels.py's shapes, and the
# shapes the tensor-core bodies do not take
PLAN_CASES = {
    "granite prefill gate/up": ((4, 48, 432, 1536), (48, 1536, 512),
                                "bfloat16", ("tc_gmm", 1)),
    "granite prefill down": ((4, 48, 432, 512), (48, 512, 1536), "bfloat16",
                             ("tc_gmm", 1)),
    "granite decode gate/up": ((4, 48, 8, 1536), (48, 1536, 512),
                               "bfloat16", ("gemv_decode", 4)),
    "granite decode down": ((4, 48, 8, 512), (48, 512, 1536), "bfloat16",
                            ("gemv_decode", 2)),
    "granite prefill, float32": ((4, 48, 432, 1536), (48, 1536, 512),
                                 "float32", ("fp32_tiled", 1)),
    "granite decode, float32": ((4, 48, 8, 1536), (48, 1536, 512),
                                "float32", ("fp32_tiled", 1)),
    **{f"test_kernels {s}": ((s[0], s[1], s[2]), (s[0], s[2], s[3]),
                             "bfloat16", ("tc_gmm", 1)) for s in GMM_SHAPES},
    **{f"test_kernels {s}, float32": ((s[0], s[1], s[2]), (s[0], s[2], s[3]),
                                      "float32", ("fp32_tiled", 1))
       for s in GMM_SHAPES},
    "16 rows a group": ((2, 6, 16, 32), (6, 32, 24), "bfloat16",
                        ("gemv_decode", 1)),
    "17 rows a group": ((2, 6, 17, 32), (6, 32, 24), "bfloat16",
                        ("tc_gmm", 1)),
    "unaligned (5, 3, 17, 9)": ((2, 5, 3, 17), (5, 17, 9), "bfloat16",
                                ("fp32_tiled", 1)),
    "F not a multiple of 8": ((4, 64, 128), (4, 128, 20), "bfloat16",
                              ("fp32_tiled", 1)),
    "D not a multiple of 8": ((2, 4, 8, 36), (4, 36, 64), "bfloat16",
                              ("fp32_tiled", 1)),
    "D 0": ((2, 32, 0), (2, 0, 16), "bfloat16", ("fp32_tiled", 1)),
    "long D": ((1, 4, 8, 8192), (4, 8192, 64), "bfloat16",
               ("gemv_decode", 8)),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_names_the_body(case):
    """``kernel.plan`` takes bf16 groups of more than 16 rows to the
    tensor-core body, of at most 16 (decode) to the GEMV body with its D
    slices, and float32 or shapes TMA's 16-byte strides refuse to the
    CUDA-core body; from the shapes and the type alone."""
    x_shape, w_shape, dtype, want = PLAN_CASES[case]
    got = kernel.plan(torch.Size(x_shape), torch.Size(w_shape),
                      DTYPES[dtype][1])
    assert (got.body, got.splits) == want and got.body in kernel.BODIES


@pytest.mark.parametrize("d,splits", [(8, 1), (511, 1), (512, 2),
                                      (1023, 2), (1024, 4), (1536, 4),
                                      (2048, 8), (100000, 8)])
def test_decode_splits_keep_256_rows_a_slice(d, splits):
    assert kernel.decode_splits(d) == splits
    assert splits == 1 or d // splits >= kernel.MIN_SPLIT_ROWS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GMM_SHAPES)
def test_probe_matches_reference_and_pallas(shape, dtype):
    """The coverage probe's expected product (from its codes alone) is the
    plain version's, the reference's ``gmm_ref``'s and its Pallas
    kernel's (interpret mode) exactly, in both types, with sizes 0, 1,
    63-65, 127-129, C - 1, C, > C and -3."""
    e, c, d, f = shape
    x, w, sizes = gmm_probe.probe_inputs((), e, c, d, f, DTYPES[dtype][1])
    want = gmm_probe.probe_expected((), e, c, d, f)
    assert sorted(set(sizes.tolist())) == sorted(set(
        (0, 1, 63, 64, 65, 127, 128, 129, c - 1, c, c + 5, -3)[:e]))
    assert torch.equal(gmm_ref(x, w, sizes).float(), want)
    jdt = DTYPES[dtype][0]
    jx = jnp.asarray(x.float().numpy(), jdt)
    jw = jnp.asarray(w.float().numpy(), jdt)
    js = jnp.asarray(sizes.numpy())
    for got in (j_gmm_ref(jx, jw, js), j_gmm(jx, jw, js, **GMM_BLOCKS)):
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      want.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_batched_matches_pallas_row_by_row(dtype):
    """The probe with a batch axis (sizes cycling over all 18 groups):
    each batch row's expected product is the reference's Pallas kernel's
    on that row, exactly."""
    lead, (e, c, d, f) = (3,), (6, 16, 32, 24)
    x, w, sizes = gmm_probe.probe_inputs(lead, e, c, d, f, DTYPES[dtype][1])
    want = gmm_probe.probe_expected(lead, e, c, d, f)
    assert torch.equal(ops.moe_gmm(x, w, sizes).float(), want)
    jdt = DTYPES[dtype][0]
    for b in range(lead[0]):
        got = j_gmm(jnp.asarray(x[b].float().numpy(), jdt),
                    jnp.asarray(w.float().numpy(), jdt),
                    jnp.asarray(sizes[b].numpy()), **GMM_BLOCKS)
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      want[b].numpy())


def _probe_fault(fault, x, w, sizes):
    """The plain product with one of the faults the probe must show."""
    if fault == "wrong expert":
        return gmm_ref(x, w.roll(1, 0), sizes)
    if fault == "dropped k tile":
        x = x.clone()
        x[..., 64:128] = 0
        return gmm_ref(x, w, sizes)
    if fault == "sizes of another group":
        return gmm_ref(x, w, sizes.roll(1, -1))
    if fault == "rows past the size kept":
        return gmm_ref(x, w, torch.full_like(sizes, x.shape[-2]))
    out = gmm_ref(x, w, sizes).clone()
    if fault == "column shifted at a tile edge":
        out[..., 128:] = out[..., 127:-1].clone()
    elif fault == "row shifted at a tile edge":
        out[..., 128:, :] = out[..., 127:-1, :].clone()
    return out


@pytest.mark.parametrize("fault", [
    "wrong expert", "dropped k tile", "sizes of another group",
    "rows past the size kept", "column shifted at a tile edge",
    "row shifted at a tile edge"])
def test_probe_shows_each_fault(fault):
    """Each fault the probe is meant to catch changes its product: a wrong
    expert, a k tile of 64 left out, another group's size, rows past the
    size not zeroed, a column or a row shifted by one at a 128 edge."""
    lead, (e, c, d, f) = (2,), (6, 200, 256, 192)
    x, w, sizes = gmm_probe.probe_inputs(lead, e, c, d, f, torch.bfloat16)
    want = gmm_probe.probe_expected(lead, e, c, d, f)
    assert torch.equal(gmm_ref(x, w, sizes).float(), want)
    bad = _probe_fault(fault, x, w, sizes).float()
    assert not torch.equal(bad, want)


# ------------------------------------------------------------ MoE layer ----
def _ref_routing(jcfg, p, x, capacity_factor):
    """The reference's routing integers, step by step as
    ``repro.models.mlp.moe`` computes them (``mlp.py:91-122``)."""
    dt = jnp.float32
    b, s, _ = x.shape
    e, k = jcfg.padded_experts, jcfg.top_k
    logits = jnp.einsum("bsd,de->bse", x.astype(dt), p.router.astype(dt))
    pad = jnp.arange(e) >= jcfg.n_experts
    logits = jnp.where(pad[None, None, :], -1e30, logits)
    _, expert_ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    flat = expert_ids.reshape(b, s * k)
    order = jnp.argsort(flat, axis=-1, stable=True)
    sorted_experts = jnp.take_along_axis(flat, order, axis=-1)
    pos = jnp.cumsum(jnp.ones_like(sorted_experts), axis=-1) - 1
    start = jax.vmap(lambda se: jnp.searchsorted(se, jnp.arange(e),
                                                 side="left"))(sorted_experts)
    pos_in = pos - jnp.take_along_axis(start, sorted_experts, axis=-1)
    cap = jm.moe_capacity(s, e, k, capacity_factor)
    keep = pos_in < cap
    counts = jax.vmap(lambda se: jnp.bincount(se, length=e))(sorted_experts)
    return {"expert_ids": expert_ids, "order": order,
            "sorted_experts": sorted_experts, "pos_in_expert": pos_in,
            "keep": keep, "sizes": jnp.minimum(counts, cap), "cap": cap}


@pytest.mark.parametrize("s,capacity_factor,drops", [
    (19, None, True), (32, None, True), (19, 100.0, False)])
def test_moe_matches_reference(ref_params, s, capacity_factor, drops):
    """One MoE layer on seeded activations: integer routing and
    ``drop_frac`` equal, output and ``aux_loss`` within 1e-5; at the
    default capacity factor both lengths drop assignments, at 100 none."""
    jcfg, cfg = _cfgs()
    node = ref_params["blocks"]["l0_attn_global"]["moe"]
    jp = jm.MoEParams(*(a[0] for a in node))
    tp = tm.MoEParams(*(torch.from_numpy(np.array(a)) for a in jp))
    x = np.random.default_rng(s).normal(size=(BATCH, s, 64)).astype(
        np.float32)
    cf = capacity_factor or jcfg.capacity_factor
    want, want_aux = jm.moe(jcfg, jp, jnp.asarray(x), capacity_factor)
    got, got_aux = tm.moe(cfg, tp, torch.from_numpy(x), capacity_factor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)
    assert abs(got_aux["aux_loss"].item()
               - float(want_aux["aux_loss"])) <= F32_TOL
    assert got_aux["drop_frac"].item() == float(want_aux["drop_frac"])
    assert (got_aux["drop_frac"].item() > 0) == drops

    r = tm.route(cfg, tp, torch.from_numpy(x), cf)
    ref = _ref_routing(jcfg, jp, jnp.asarray(x), cf)
    assert r.cap == ref["cap"]
    for name in ("expert_ids", "order", "sorted_experts", "pos_in_expert",
                 "keep", "sizes"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(ref[name]), err_msg=name)


def test_moe_capacity_counts_padded_experts():
    """The reference's rule, over the padded expert count: 432 rows for a
    2,048-token prompt, 8 for a decode step, at granite's top-8 of 48."""
    for n, e, k, cf in ((2048, 48, 8, 1.25), (1, 48, 8, 1.25),
                        (19, 48, 2, 1.25), (32, 48, 2, 100.0)):
        assert tm.moe_capacity(n, e, k, cf) == jm.moe_capacity(n, e, k, cf)
    assert tm.moe_capacity(2048, 48, 8) == 432
    assert tm.moe_capacity(1, 48, 8) == 8


def _combine_case(seed, b=2, s=19, e=40, k=8, d=64):
    """bf16 contributions in the MoE layer's sorted order and their
    tokens, from top-``k`` of ``e`` experts per token."""
    rng = np.random.default_rng(seed)
    ids = np.argsort(rng.random((b, s, e)), axis=-1)[..., :k]
    order = np.argsort(ids.reshape(b, s * k), axis=-1, kind="stable")
    contrib = np.asarray(jnp.asarray(
        rng.normal(size=(b, s * k, d)) * 3.0, jnp.bfloat16))
    return contrib, (order // k).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_combine_bitwise_at_top8(seed):
    """The combine against the reference's ``out.at[t].add(c)`` on the
    same bf16 contributions, at 40 experts and top-8: bitwise equal.  A
    float32 sum rounded once to bf16 is not."""
    contrib, tokens = _combine_case(seed)
    b, n, d = contrib.shape
    s = n // 8
    want = jax.vmap(lambda o, t, c: o.at[t].add(c))(
        jnp.zeros((b, s, d), jnp.bfloat16), jnp.asarray(tokens),
        jnp.asarray(contrib))
    ct = torch.from_numpy(np.asarray(contrib, np.float32)).to(torch.bfloat16)
    tt_ = torch.from_numpy(tokens).long()
    got = tm.combine(ct, tt_, s)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    once = torch.stack([torch.zeros((s, d)).index_add_(0, tt_[i],
                                                       ct[i].float())
                        for i in range(b)]).to(torch.bfloat16)
    assert not torch.equal(once, got)


# -------------------------------------------------------------- the model --
def _run_both(dtype, ref_params, steps=GEN, follow_ref=False):
    """Prefill and ``steps`` greedy decode steps through both packages;
    returns per step (reference logits, port logits) and the two final
    caches.  Each package decodes its own greedy token, held equal to the
    other's, or with ``follow_ref`` both decode the reference's."""
    jcfg, cfg = _cfgs(dtype)
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    toks = _prompt(cfg)
    jc, jl = jax.jit(lambda p, b: jt.prefill(jcfg, p, b, max_len=MAX_LEN))(
        ref_params, {"tokens": jnp.asarray(toks)})
    tc, tl = tt.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_len=MAX_LEN)
    out = [(np.asarray(jl), tl.numpy())]
    dec = jax.jit(lambda p, c, b, pos: jt.decode_step(jcfg, p, c, b, pos))
    for i in range(steps):
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        if follow_ref:
            ttok = torch.from_numpy(np.array(jtok))
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        jc, jl = dec(ref_params, jc, {"tokens": jtok}, jnp.int32(PROMPT + i))
        tc, tl = tt.decode_step(cfg, tp, tc, {"tokens": ttok}, PROMPT + i)
        out.append((np.asarray(jl), tl.numpy()))
    return out, jc, tc


def _cache_err(cfg, jc, tc):
    want = convert.cache_from_numpy(cfg, _np(jc))
    assert len(want) == len(tc) == cfg.n_layers
    return max((a.float() - b.float()).abs().max().item()
               for pw, pt in zip(want, tc) for a, b in zip(pw, pt))


def test_prefill_and_decode_match_reference(ref_params):
    """The prompt's logits and eight greedy decode steps: logits within
    the bound, every token equal (checked step by step), caches too."""
    out, jc, tc = _run_both("float32", ref_params)
    assert out[0][1].shape == (BATCH, 1, 128)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert _cache_err(_cfgs()[1], jc, tc) <= F32_TOL


def test_bf16_matches_reference(ref_params):
    """bf16 logits of the prompt and of eight decode steps, each taken from
    the reference's token: at the first decode step the reference's two
    best logits of batch row 0 lie 1.95e-3 apart, under the 3.9e-3 the
    two packages' bf16 logits differ by, so the greedy tokens are held
    equal in float32 only."""
    out, _, _ = _run_both("bfloat16", ref_params, follow_ref=True)
    for want, got in out:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_decode_from_reference_cache(ref_params):
    """One decode step from the reference's prefill cache carried
    across."""
    jcfg, cfg = _cfgs()
    toks = _prompt(cfg)
    jc, jl = jt.prefill(jcfg, ref_params, {"tokens": jnp.asarray(toks)},
                        max_len=MAX_LEN)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    tc = convert.cache_from_numpy(cfg, _np(jc))
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    jc2, jl2 = jt.decode_step(jcfg, ref_params, jc, {"tokens": tok},
                              jnp.int32(PROMPT))
    tc2, tl2 = tt.decode_step(cfg, tp, tc, {"tokens": torch.from_numpy(
        np.array(tok))}, PROMPT)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=0,
                               atol=F32_TOL)
    assert _cache_err(cfg, jc2, tc2) <= F32_TOL


def test_serve_matches_reference(ref_params):
    """``serve`` on the CPU against the reference's ``serve`` on the same
    prompts and weights: every generated token equal."""
    jcfg, cfg = _cfgs()
    want = j_serve.serve(jcfg, BATCH, PROMPT, GEN, seed=0)
    got = t_serve.serve(cfg, BATCH, PROMPT, GEN, seed=0, device="cpu",
                        params=convert.params_from_numpy(cfg,
                                                         _np(ref_params)))
    np.testing.assert_array_equal(got["generated"], want["generated"])
    np.testing.assert_array_equal(
        got["logits"].argmax(-1).numpy(), got["generated"])


def test_params_round_trip_without_lm_head(ref_params):
    """Reference tree -> port modules -> reference tree, bit for bit; the
    tied tree has no ``lm_head`` on either side."""
    _, cfg = _cfgs()
    assert "lm_head" not in ref_params
    tp = convert.params_from_numpy(cfg, _np(ref_params))
    assert tp.lm_head is None
    assert tp.layers[0].moe.w_gate.shape == (48, 64, 32)
    assert tp.layers[1].moe.router.shape == (64, 48)
    assert not hasattr(tp.layers[0], "mlp")
    want = jax.tree_util.tree_leaves_with_path(_as_dicts(ref_params))
    back = convert.params_to_numpy(cfg, tp)
    assert "lm_head" not in back
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_params_follows_the_reference_tree():
    """``init_params`` makes the reference's shapes and names: an ``moe``
    node per layer and no ``lm_head`` when the head is tied."""
    jcfg, cfg = _cfgs()
    tp = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    names = {n: tuple(t.shape) for n, t in tp.named_parameters()}
    ref = jax.eval_shape(lambda: jt.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {n: tuple(a.shape) for n, a in zip(
        ("router", "w_gate", "w_up", "w_down"),
        ref["blocks"]["l0_attn_global"]["moe"])}
    for n, shape in want.items():
        assert names[f"layers.1.moe.{n}"] == shape[1:], n
    assert "lm_head" not in names and tp.lm_head is None


def test_compute_copy_computes_the_same_numbers():
    """The bf16 expert weights and tied head cast once give the logits
    that casting the float32 weights at every use gives, bit for bit; the
    router stays float32, the expert weights contiguous."""
    _, cfg = _cfgs("bfloat16")
    p = tt.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = {"tokens": torch.from_numpy(_prompt(cfg))}
    copy = tt.compute_copy(cfg, p)
    moe = copy.layers[0].moe
    assert moe.w_down.dtype == torch.bfloat16 and moe.w_down.is_contiguous()
    assert moe.router.dtype == torch.float32
    assert copy.lm_head.dtype == torch.bfloat16
    assert copy.lm_head.shape == (64, 128)
    c1, l1 = tt.prefill(cfg, p, toks, max_len=MAX_LEN)
    c2, l2 = tt.prefill(cfg, copy, toks, max_len=MAX_LEN)
    assert torch.equal(l1, l2)
    tok = torch.argmax(l1, -1).to(torch.int32)
    _, d1 = tt.decode_step(cfg, p, c1, {"tokens": tok}, PROMPT)
    _, d2 = tt.decode_step(cfg, copy, c2, {"tokens": tok}, PROMPT)
    assert torch.equal(d1, d2)


def test_full_width_config_is_granite_moe_3b_a800m():
    cfg = get_arch(ARCH)
    tt.check_supported(cfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab) == (
                32, 1536, 24, 8, 64, 512, 49155)
    assert (cfg.n_experts, cfg.padded_experts, cfg.top_k,
            cfg.tie_embeddings, cfg.moe_dense_residual,
            cfg.compute_dtype) == (40, 48, 8, True, False, "bfloat16")
    assert cfg.param_count() == j_arch(ARCH).param_count()
