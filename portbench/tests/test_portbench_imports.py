"""The import guard: nothing the benchmark runs loads JAX or the JAX
package (top-level names compared whole), and the references import
nothing of the program."""
import ast
import subprocess
import sys

import pb_env

ROOT = pb_env.ROOT
BANNED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_name_no_banned_module():
    for path in (ROOT / "portbench").rglob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "portbench/reference").glob("*.py"):
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert "repro_torch" not in tops, path
        assert tops <= {"__future__", "importlib", "math", "typing",
                        "torch", "portbench"}, (path, tops)
        for m in _imports(path):
            if m.startswith("portbench"):
                assert m.startswith("portbench.reference"), (path, m)


def test_a_run_loads_no_banned_module():
    """Every module ``run.py`` loads for a run (the harness, the readers,
    the checks, the references and the program's entry points), in a
    fresh interpreter."""
    code = (
        "import sys; sys.argv = ['run.py'];"
        f"sys.path[:0] = [{str(ROOT / 'portbench')!r}];"
        "import run; run._environment();"
        "from portbench import harness, check, devtrace, arith;"
        "from portbench.reference import llama, mamba2;"
        "import repro_torch.core, repro_torch.models.lm, "
        "repro_torch.train.step, torch.profiler;"
        "[harness.reader(n) for n in ('tokens_per_s', 'step_mfu', "
        "'mfu.commit', 'commit_kernel_roofline')];"
        "harness.load_spec('smollm-360m.regen');"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_whole_names():
    from portbench import harness
    sys.modules.setdefault("repro_torch_lookalike", sys)
    assert "repro_torch_lookalike" not in harness.forbidden_modules()
    sys.modules["repro.fake_for_guard"] = sys
    try:
        assert "repro.fake_for_guard" in harness.forbidden_modules()
    finally:
        del sys.modules["repro.fake_for_guard"]
    del sys.modules["repro_torch_lookalike"]
