"""No module that the benchmark runs has the top-level name jax, jaxlib,
flax or icspcodec_tpu, compared whole (icspcodec_torch shares a prefix
with icspcodec_tpu, so a prefix test would be wrong); and the plain
reference imports nothing of the program."""
import ast
import json
import pathlib
import subprocess
import sys

from benchlib import cell, manifest

FOREIGN = {"jax", "jaxlib", "flax", "icspcodec_tpu"}
BENCH = manifest.BENCH_DIR


def _imported_tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.partition(".")[0])
    return tops


def test_whole_name_comparison():
    assert "icspcodec_torch".partition(".")[0] not in FOREIGN
    assert "icspcodec_tpu.codec".partition(".")[0] in FOREIGN
    assert set(cell.FOREIGN) == FOREIGN


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not _imported_tops(path) & FOREIGN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "benchref").glob("*.py"):
        assert not _imported_tops(path) & (FOREIGN | {"icspcodec_torch", "torch"}), path


_PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
{body}
print(json.dumps(sorted({{m.partition(".")[0] for m in sys.modules}})))
"""


def _tops_after(body: str) -> set[str]:
    code = _PROBE.format(root=str(manifest.ROOT), bench=str(BENCH), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True, cwd=str(manifest.ROOT)).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a cell on the CPU, in a fresh process, with every
    metric's reader loaded: nothing of JAX or the JAX package is loaded."""
    tops = _tops_after(
        "import runpy; runpy.run_path({run!r}, run_name='bench_run')\n"
        "from benchlib import cell, manifest\n"
        "m = manifest.load()\n"
        "[manifest.reader(x['name']) for x in m['end_to_end'] + m['per_layer']]\n"
        "r, i = cell.run_cell('cif_p10_gop4.encode', 3, 0.05, False, device_kind='cpu',\n"
        "                     overrides={{'frames': 12}}, workers=1)\n"
        "assert r['correct'] and not i['foreign_modules']".format(run=str(BENCH / "run.py")))
    assert "icspcodec_torch" in tops and not tops & FOREIGN


def test_the_reference_alone_loads_nothing_of_the_program():
    tops = _tops_after(
        "import numpy as np\n"
        "from benchlib import content\n"
        "from benchref.clip import encode_clip\n"
        "c = content.clip('benchA', 1, 3, 112, 80)\n"
        "encode_clip(*c, 16, 16, 2, decode=True, workers=1)")
    assert not tops & (FOREIGN | {"icspcodec_torch", "torch"})
