"""The port's trace-fitting CLI (``scripts/torch_fit_hazard.py``) against
the reference's ``scripts/fit_hazard.py``.

Both scripts run as subprocesses: on the same synthetic failure log the
port's fit JSON equals the reference's byte for byte (stdout and ``-o``),
``--selftest --device cpu`` passes, and neither the CLI nor
``repro_torch.studies.paper_tables`` loads ``jax`` or ``repro``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "scripts" / "torch_fit_hazard.py"
REFERENCE = ROOT / "scripts" / "fit_hazard.py"


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _run(*args, timeout=120):
    return _wait(_start(*args), timeout)


def _start(*args):
    return subprocess.Popen([sys.executable, *map(str, args)], cwd=ROOT,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


@pytest.fixture(scope="module")
def failure_log(tmp_path_factory):
    """A failure log with a server column and an event column: early
    failures at 1/50 min, later ones at 1/500, and repair rows that the
    ``--event failure`` filter drops."""
    rng = np.random.default_rng(11)
    rows = []
    for server in range(30):
        t = 0.0
        for k in range(7):
            t += float(rng.exponential(50.0 if k < 2 else 500.0))
            rows.append((t, server, "failure"))
            rows.append((t + 30.0, server, "repair"))
    path = tmp_path_factory.mktemp("log") / "events.csv"
    with path.open("w") as fh:
        fh.write("time,server,event\n")
        for t, server, ev in sorted(rows):
            fh.write(f"{t:.4f},{server},{ev}\n")
    return path


@pytest.mark.parametrize("extra", [
    ("--event", "failure"),
    ("--event", "failure", "--bins", "5", "--method", "binned", "-o"),
], ids=["nelson-aalen-stdout", "binned-file"])
def test_fit_json_equals_the_reference_byte_for_byte(failure_log, tmp_path,
                                                     extra):
    """Both scripts at once on the same log: the same bytes on stdout, or
    in the ``-o`` file."""
    to_file = extra[-1] == "-o"
    outs = {name: tmp_path / f"{name}.json" for name in ("ref", "port")}
    procs = {name: _start(script, failure_log, *extra,
                          *([outs[name]] if to_file else []))
             for name, script in (("ref", REFERENCE), ("port", PORT))}
    done = {name: _wait(proc) for name, proc in procs.items()}
    for name, d in done.items():
        assert d.returncode == 0, (name, d.stderr)
    if to_file:
        assert "segments" in done["port"].stderr
        assert outs["port"].read_bytes() == outs["ref"].read_bytes()
        assert b'"edges"' in outs["port"].read_bytes()
    else:
        assert done["port"].stdout == done["ref"].stdout
        assert '"edges"' in done["port"].stdout


def test_selftest_on_the_cpu():
    done = _run(PORT, "--selftest", "--device", "cpu")
    assert done.returncode == 0, done.stderr
    assert "fit_hazard selftest OK" in done.stdout


def test_no_log_is_an_error():
    done = _run(PORT)
    assert done.returncode == 2 and "event log is required" in done.stderr


def test_port_files_load_no_jax():
    """Importing the CLI and the paper-tables module loads neither ``jax``
    nor anything of the reference package."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('cli', {str(PORT)!r})\n"
        "cli = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(cli)\n"
        "import repro_torch.studies.paper_tables\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n")
    done = _run("-c", code)
    assert done.returncode == 0, done.stderr
    assert "LOADED []" in done.stdout
