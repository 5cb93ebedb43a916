"""The run's boundaries: no card means no result and a non-zero exit, and
nothing the harness loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from gatebench_tiny import GATED, REPO  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# The whole run's window.  It opens as a batch ends; the next batch was
# submitted before it opened, so the window's own requests are answered by
# the batch after that at the earliest.  A window of half a second held none
# of them in some runs under six parallel test workers (a batch took longer),
# and the front end's readers then had nothing to read.
WINDOW_S = 3.0


def run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env={**os.environ, **env})


def test_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "gatebench/run.py", "--workload", GATED[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "CUDA device" in p.stderr
    for line in p.stdout.splitlines():
        assert not line.strip().startswith("{")


def test_forbidden_names_are_whole_top_level_names():
    p = run("import sys; sys.path.insert(0, 'gatebench'); import run; "
            "sys.modules['repro_torch.x'] = sys; sys.modules['jaxlike'] = sys; "
            "print(run.forbidden_modules()); sys.modules['repro.core'] = sys; "
            "print(run.forbidden_modules())")
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[:2] == ["[]", "['repro']"]


def test_a_whole_run_loads_no_jax_and_the_reference_no_program():
    code = (
        f"WINDOW_S = {WINDOW_S}\n"
        "import sys, json, time; sys.path[:0] = ['gatebench/tests']\n"
        "import gatebench_tiny as t\n"
        "from gatebench import reference, check, data, index, devtrace\n"
        "ref_only = sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')\n"
        "cell = t.tiny_cell(t.GATED[0], n=800)\n"
        "res, rows = t.harness.run_cell(cell, 3, WINDOW_S, True, 'cpu', time.perf_counter(),\n"
        "                               t.cell_metrics(cell.name, 'per_layer'))\n"
        "print(json.dumps({'ref_only': ref_only, 'correct': res['correct'],\n"
        "                  'metrics': sorted(res['metrics']),\n"
        "                  'top': sorted({m.split('.')[0] for m in sys.modules})}))\n")
    p = run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["ref_only"] == []
    assert "repro_torch" in out["top"]
    assert not FORBIDDEN & set(out["top"])
    assert out["correct"]
    # on the CPU the per-layer readers of the window, the program's spans
    # and counters read; those of the device trace find nothing and are
    # left out
    assert out["metrics"] == sorted(["batch_size_mean", "queue_wait_ms", "reads_per_query",
                                     "search_ms_per_round", "served_qps",
                                     "tunnels_per_query"])


def test_reference_imports_nothing_of_the_program():
    p = run("import sys; sys.path.insert(0, '.'); import gatebench.reference, gatebench.check; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
