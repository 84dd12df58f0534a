"""What the benchmark's processes import: no JAX and no JAX package (by whole
top-level names), and nothing of the port in the references."""

import subprocess
import sys

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "ipoke_tpu"}


def top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = [{str(BENCH)!r}, "
         f"{str(BENCH.parent)!r}]\n{code}\nprint(sorted({{m.split('.')[0] for m in sys.modules}}))"],
        capture_output=True, text=True, check=True, timeout=600)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_references_import_neither_jax_nor_the_port():
    found = top_level_after(
        "import importlib, pathlib\n"
        f"for p in sorted(pathlib.Path({str(BENCH / 'reference')!r}).glob('*.py')):\n"
        "    importlib.import_module('reference.' + p.stem)")
    assert not found & (FORBIDDEN | {"ipoke_tpu_torch"})


def test_a_run_imports_no_jax():
    """A whole run of each cell on the CPU, its port and all: the run itself
    refuses to print a result (exit 3) if it holds a forbidden module."""
    found = top_level_after(
        "import sys, time, json\n"
        "sys.path.insert(0, " + repr(str(BENCH / "tests")) + ")\n"
        "from conftest import small_cell\n"
        "import harness\n"
        "for w in ('cinn128_sample_div', 'fs64_train'):\n"
        "    rc = harness.run(['--workload', w, '--seed', '7', '--seconds', '0.5', '--trace', '1'],\n"
        "                     time.perf_counter(), cell=small_cell(w), device='cpu')\n"
        "    assert rc == 0, rc\n"
        "import harness, readers, readings, weights")
    assert "ipoke_tpu_torch" in found and not found & FORBIDDEN
