"""repro_torch stands alone: importing it and every submodule, and running
chip_smoke.py's port drivers, loads neither JAX nor anything of the
reference package ``repro``; its entry points run on the card unless the
caller asks for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(info.name)
    return names


def test_import_loads_no_jax_and_no_repro():
    mods = _modules()
    assert "repro_torch.kernels.soc_step.kernel" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax_or_repro_import():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro\b|"
                     r"from\s+repro\.|import\s+repro\b)", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert not hits, hits


def test_new_subpackages_are_covered():
    """The fault model, the checkpoint package, the neural agent, the
    design-space sampler, XLA's float32 functions, the LM stack (configs,
    synthetic data, models, launch, the flash-attention, RWKV-6 scan,
    grouped expert-matmul and RG-LRU scan kernels) and LM training (the
    kernels' gradient wrapper, the optimizers, the prefetch pipeline, the
    fault helpers, the train step and launcher, the memory-mode
    autotuner), the distributed layer and the dry-run and roofline are
    among the modules the import check above loads."""
    mods = _modules()
    for m in ("repro_torch.soc.faults", "repro_torch.checkpoint",
              "repro_torch.checkpoint.ckpt",
              "repro_torch.checkpoint.manager", "repro_torch.soc.nn",
              "repro_torch.soc.dse", "repro_torch.xla_math",
              "repro_torch.configs", "repro_torch.configs.qwen3_8b",
              "repro_torch.data.synthetic", "repro_torch.models.attention",
              "repro_torch.models.transformer", "repro_torch.models.convert",
              "repro_torch.launch.serve",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.flash_attention.ref",
              "repro_torch.models.rwkv6",
              "repro_torch.kernels.rwkv6_scan.kernel",
              "repro_torch.kernels.rwkv6_scan.ops",
              "repro_torch.kernels.rwkv6_scan.ref",
              "repro_torch.kernels.moe_gmm.kernel",
              "repro_torch.kernels.moe_gmm.ops",
              "repro_torch.kernels.moe_gmm.ref",
              "repro_torch.models.rglru",
              "repro_torch.kernels.rglru_scan.kernel",
              "repro_torch.kernels.rglru_scan.ops",
              "repro_torch.kernels.rglru_scan.ref",
              "repro_torch.kernels.autograd", "repro_torch.optim",
              "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
              "repro_torch.optim.compress", "repro_torch.optim.schedule",
              "repro_torch.data.pipeline",
              "repro_torch.distributed.fault", "repro_torch.launch.steps",
              "repro_torch.launch.train", "repro_torch.core.autotune",
              "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
              "repro_torch.launch.roofline", "repro_torch.launch.dryrun"):
        assert m in mods, m


def test_chip_smoke_and_port_drivers_load_no_jax():
    """chip_smoke.py and the port drivers it runs import neither JAX nor
    repro, at import and on the port's path (Fig. 10, Fig. 11's DES
    cross-check, Fig. 12 and Fig. 13 at a tiny size, Fig. 6's fidelity
    path on one weighting and Fig. 9's cross-check on one lane, and the
    Qwen3, rwkv6, granite, recurrentgemma, arctic, musicgen, qwen2-vl and
    int8-cache smoke serves, smoke training with checkpoints, compression
    and the autotuner); nor do the throughput and overhead drivers and
    ``soc.shard``."""
    root = SRC.parent
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "from benchmarks import torch_fig9_socs, torch_fig11_serving\n"
        "from benchmarks import torch_vecenv_throughput, torch_overhead\n"
        "from benchmarks import torch_roofline_table\n"
        "from benchmarks import torch_fig10_faults as f10\n"
        "from benchmarks import torch_fig12_dse as f12\n"
        "from benchmarks import torch_fig13_generalize as f13\n"
        "from benchmarks import torch_fig6_reward_dse as f6\n"
        "f6.des_points(f6.WEIGHTS[:1], 1, 'cpu')\n"
        "assert torch_fig9_socs.crosscheck_port('cpu', [('SoC1', 'mixed')])"
        "['agree']\n"
        "from repro_torch.soc import shard\n"
        "assert torch_fig11_serving.des_crosscheck('cpu', n=32)['agree']\n"
        "assert f12.run_port('cpu', n=4)['_engine']['calls_ok']\n"
        "from repro_torch.configs import smoke_config\n"
        "from repro_torch.launch import serve\n"
        "f10.run_port('cpu', iters=1, n_phases=2)\n"
        "assert f10.des_crosscheck('cpu')['agree']\n"
        "f13.run_port('cpu', n_train=1, n_heldout=1, n_phases=1, "
        "iterations=1, batch=1)\n"
        "out = serve.serve(smoke_config('qwen3-8b'), 2, 8, 2, "
        "device='cpu')\n"
        "assert out['generated'].shape == (2, 2)\n"
        "out = serve.serve(smoke_config('rwkv6-3b'), 2, 16, 2, "
        "device='cpu')\n"
        "assert out['generated'].shape == (2, 2)\n"
        "out = serve.serve(smoke_config('granite-moe-3b-a800m'), 2, 8, 2, "
        "device='cpu')\n"
        "assert out['generated'].shape == (2, 2)\n"
        "out = serve.serve(smoke_config('recurrentgemma-9b'), 2, 11, 2, "
        "device='cpu')\n"
        "assert out['generated'].shape == (2, 2)\n"
        "for arch in ('arctic-480b', 'qwen2-vl-2b'):\n"
        "    out = serve.serve(smoke_config(arch), 2, 8, 2, device='cpu')\n"
        "    assert out['generated'].shape == (2, 2)\n"
        "out = serve.serve(smoke_config('musicgen-large'), 2, 8, 2, "
        "device='cpu')\n"
        "assert out['generated'].shape == (2, 2, 2, 1)\n"
        "out = serve.serve(smoke_config('qwen3-8b').replace("
        "kv_cache_dtype='int8'), 2, 8, 2, device='cpu')\n"
        "assert out['generated'].shape == (2, 2)\n"
        "import tempfile\n"
        "from repro_torch.launch import train\n"
        "for arch, extra in (('qwen2-vl-2b', ['--compress']), "
        "('qwen3-8b', ['--autotune'])):\n"
        "    losses = train.main(['--arch', arch, '--smoke', "
        "'--device', 'cpu', '--steps', '2', '--batch', '2', '--seq', '16', "
        "'--ckpt-dir', tempfile.mkdtemp(), '--ckpt-every', '1'] + extra)\n"
        "    assert len(losses) == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{root}")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA: without a card every entry point
    raises rather than running on the CPU."""
    import torch
    from benchmarks import torch_fig10_faults, torch_fig13_generalize
    from repro_torch.configs import smoke_config
    from repro_torch.core import orchestrator
    from repro_torch.launch import serve
    from repro_torch.soc import stacked, vecenv
    from repro_torch.soc.config import SOCS
    soc = SOCS["SoC1"]
    makers = [lambda: vecenv.VecEnv(soc).device,
              lambda: stacked.StackedVecEnv([soc]).device,
              lambda: orchestrator.train_cohmeleon_batched(
                  soc, iterations=1, n_phases=1).env.device]
    if torch.cuda.is_available():
        for make in makers:
            assert make().type == "cuda"
        return
    from repro_torch.launch import steps, train
    for make in makers + [lambda: torch_fig10_faults.run_port(),
                          lambda: torch_fig13_generalize.run_port(),
                          lambda: serve.serve(smoke_config("qwen3-8b"), 1,
                                              4, 1),
                          lambda: steps.make_train_state(
                              smoke_config("qwen3-8b")),
                          lambda: train.main(["--arch", "qwen3-8b",
                                              "--smoke", "--steps", "1"])]:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
