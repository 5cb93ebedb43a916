"""Import guard: the port reaches neither JAX nor the reference package.

Every module of ``repro_torch``, ``chip_smoke.py`` up to its ``main``,
and every entry point ``examples/torch_*.py`` and ``scripts/torch_*.py``
(loaded as a module: its ``main`` does not run) is imported in a fresh
interpreter where ``jax`` and ``repro`` are poisoned
(``sys.modules[name] = None`` makes any import of them raise).
Importing builds no kernel.
"""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

GUARD = textwrap.dedent("""
    import glob, importlib, importlib.util, os, pkgutil, sys
    for name in ("jax", "jaxlib", "repro"):
        sys.modules[name] = None
    sys.path.insert(0, {src!r})
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke", {smoke!r})
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert callable(smoke.main)
    for folder in ("examples", "scripts"):
        for path in sorted(glob.glob(os.path.join({repo!r}, folder, "torch_*.py"))):
            name = "entry." + folder + "." + os.path.basename(path)[:-3]
            spec = importlib.util.spec_from_file_location(name, path)
            entry = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(entry)
            assert callable(entry.main), path
            names.append(name)
    from repro_torch.kernels import _build
    assert not _build._LIBS, "a kernel was built or loaded at import time"
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print(" ".join(names))
""")

# modules the port must hold: the disk tier, the kernels, the build, the cache
# tiers, telemetry, retrieval serving, distributed search, and the LM side
# (configs, models, the token stream, the prefill and decode steps, the
# optimizers, the train step, the checkpointer and the training launcher),
# and the sharding plans, gradient compression and fault tolerance
EXPECTED = {
    "repro_torch.core.engine", "repro_torch.core.search", "repro_torch.core.pq",
    "repro_torch.core.io_model", "repro_torch.core.graph",
    "repro_torch.store.cache", "repro_torch.store.adaptive",
    "repro_torch.store.disk", "repro_torch.store.faults", "repro_torch.store.staging",
    "repro_torch.store.vector_store", "repro_torch.store.format",
    "repro_torch.kernels.ops", "repro_torch.kernels.topk_merge",
    "repro_torch.kernels.pq_lookup", "repro_torch.kernels.l2_dist",
    "repro_torch.kernels.fused_traversal",
    "repro_torch.obs", "repro_torch.obs.registry", "repro_torch.obs.tracer",
    "repro_torch.obs.stats", "repro_torch.obs.export",
    "repro_torch.serve", "repro_torch.serve.rag", "repro_torch.serve.server",
    "repro_torch.launch", "repro_torch.launch.mesh", "repro_torch.core.distributed_search",
    "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.registry",
    *(f"repro_torch.configs.{m}" for m in (
        "dbrx_132b", "deepseek_coder_33b", "gemma3_4b", "gemma_7b", "internvl2_2b",
        "llama4_maverick", "musicgen_medium", "qwen2_5_32b", "recurrentgemma_9b", "xlstm_350m")),
    "repro_torch.models", "repro_torch.models.layers", "repro_torch.models.attention",
    "repro_torch.models.transformer", "repro_torch.models.zoo", "repro_torch.models.convert",
    "repro_torch.models.moe", "repro_torch.models.rglru", "repro_torch.models.xlstm",
    "repro_torch.data.tokens", "repro_torch.serve.decode", "repro_torch.serve.prefill",
    "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.schedules",
    "repro_torch.train", "repro_torch.train.train_step",
    "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer", "repro_torch.launch.train",
    "repro_torch.distributed", "repro_torch.distributed.compression",
    "repro_torch.distributed.fault_tolerance", "repro_torch.distributed.sharding",
}

# the reference's command-line surface in the port, each loaded without
# running its main
ENTRY_POINTS = {
    *(f"entry.examples.torch_{m}" for m in (
        "quickstart", "filtered_search_demo", "rag_serve", "train_lm")),
    *(f"entry.scripts.torch_{m}" for m in (
        "convert_index", "obs_report", "smoke_core", "diag_recall", "smoke_models")),
}


def test_port_imports_neither_jax_nor_repro():
    code = GUARD.format(src=os.path.join(REPO, "src"), smoke=os.path.join(REPO, "chip_smoke.py"),
                        repo=REPO)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 40 and EXPECTED <= names, sorted(EXPECTED - names)
    assert ENTRY_POINTS <= names, sorted(ENTRY_POINTS - names)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a CUDA device the smoke run exits non-zero and prints no
    result line."""
    code = textwrap.dedent(f"""
        import sys, runpy, torch
        torch.cuda.is_available = lambda: False
        sys.argv = ["chip_smoke.py"]
        runpy.run_path({os.path.join(REPO, "chip_smoke.py")!r}, run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_refuses(tmp_path):
    """Copied without the rest of the repository, the smoke run cannot
    find the port: it exits non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
