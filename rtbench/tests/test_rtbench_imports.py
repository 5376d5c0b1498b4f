"""Nothing the benchmark runs loads JAX or the JAX package (whole top-level
names: tracer_torch is not tracer), and the reference loads no part of the
program."""
import ast
import json
import subprocess
import sys

from rtbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "tracer"}


def loaded_after(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after `code`."""
    prog = (f"import sys; sys.path.insert(0, {str(harness.ROOT)!r}); {code}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_no_program_and_no_jax():
    mods = loaded_after("import rtbench.reference, rtbench.checks, rtbench.generate, "
                        "rtbench.scenes; rtbench.scenes.make({'kind': 'bunny', 'subdiv': 1})")
    assert not mods & (FORBIDDEN | {"tracer_torch"})


def test_a_run_loads_no_jax():
    code = ("import time; sys.path.insert(0, %r); from tiny import tiny_cell; "
            "from rtbench import harness, plugins; "
            "plugins.load('loops', 'frames', harness.ROOT).SAMPLE_STRIDE = 2; "
            "r = harness.run_cell(tiny_cell('bunny512.orbit'), 3, 1.0, True, 'cpu', time.time()); "
            "assert r['correct'] and not harness.forbidden_modules()"
            % str(harness.HERE / "tests"))
    mods = loaded_after(code)
    assert "tracer_torch" in mods and not mods & FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tracer_torch_x", sys)
    assert "tracer" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tracer.api", sys)
    assert "tracer" in harness.forbidden_modules()
