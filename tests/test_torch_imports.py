"""The port stands alone: importing every module of icspcodec_torch (the
oracle and parallel.* included) in a fresh interpreter loads neither jax
nor anything of icspcodec_tpu."""
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import icspcodec_torch
names = sorted(m.name for m in pkgutil.walk_packages(icspcodec_torch.__path__, "icspcodec_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "icspcodec_tpu"))
print(len(names), " ".join(names))
assert not bad, bad
"""


def test_every_module_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    names = r.stdout.split()[1:]
    for want in ("icspcodec_torch.oracle", "icspcodec_torch.parallel.gop",
                 "icspcodec_torch.parallel.distributed", "icspcodec_torch.parallel.tiles",
                 "icspcodec_torch.codec", "icspcodec_torch.cli"):
        assert want in names
