"""The torch port stands alone: importing every module of
``automodel_tpu_torch`` pulls in neither JAX nor anything of the JAX
package, and no source file (chip_smoke.py and chip_grouped_ab.py
included) imports them."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax\w*|automodel_tpu)(?:\.|\s|$)", re.M)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import automodel_tpu_torch\n"
        "for m in pkgutil.walk_packages(automodel_tpu_torch.__path__, 'automodel_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'automodel_tpu'))\n"
        "print(len([k for k in sys.modules if k.startswith('automodel_tpu_torch')]), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    n_files = sum(
        name.endswith(".py") for _, _, names in os.walk(os.path.join(REPO, "automodel_tpu_torch")) for name in names
    )
    assert int(n) == n_files and bad == "[]", out.stdout


def test_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "chip_grouped_ab.py", "chip_serving_ab.py")]
    for root, _, names in os.walk(os.path.join(REPO, "automodel_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = {}
    for path in files:
        hits = _IMPORT.findall(open(path).read())
        if hits:
            offenders[os.path.relpath(path, REPO)] = hits
    assert len(files) > 40 and not offenders, offenders


@pytest.mark.parametrize(
    "module,name",
    [
        ("automodel_tpu_torch.serving.block_pool", "HostSpillTier"),
        ("automodel_tpu_torch.resilience.preemption", "PreemptionHandler"),
        ("automodel_tpu_torch.resilience.watchdog", "EngineWatchdog"),
        ("automodel_tpu_torch.telemetry.flight_recorder", "FlightRecorder"),
        ("automodel_tpu_torch.telemetry.prometheus", "ServingMetrics"),
        ("automodel_tpu_torch.serving.server", "serve_http"),
    ],
)
def test_the_serving_front_is_the_ports_own_copy(module, name):
    """The serving front's pieces are defined in the port itself (copies of
    the JAX package's jax-free modules, never imports of them), and
    importing them loads no JAX."""
    code = (
        "import importlib, sys\n"
        f"obj = getattr(importlib.import_module({module!r}), {name!r})\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'automodel_tpu'))\n"
        "print(obj.__module__, bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [module, "[]"], out.stdout
