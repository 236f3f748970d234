"""Nothing under portbench imports JAX, flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), the
reference imports nothing of the port either, and a run leaves none of them
loaded. Without a card the benchmark prints no result and exits 2."""
import ast
import subprocess
import sys

from portbench import harness, run

FORBIDDEN = {"jax", "jaxlib", "flax", "metaviterbinet_tpu"}
PORT = "metaviterbinet_tpu_torch"


def imported(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax():
    files = list((harness.ROOT / "portbench").rglob("*.py"))
    assert files
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in (harness.ROOT / "portbench" / "reference").rglob("*.py"):
        assert PORT not in imported(f), f


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "metaviterbinet_tpu_torch_x", sys)
    assert "metaviterbinet_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "metaviterbinet_tpu.config", sys)
    assert run.forbidden_modules() == ["metaviterbinet_tpu"]


def test_a_run_loads_none_of_them():
    code = ("import sys, time, torch\n"
            "torch.set_num_threads(1)\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            "cell = tiny.cell('lstm.train')\n"
            "cell.driver().run(cell, 3, 0.5, False, torch.device('cpu'), time.time())\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "viterbinet.meta",
                          "--seed", str(2**31 + 3), "--seconds", "1"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
