"""The per-test time limit of ``tests/conftest.py``: its table of named
tests stays true to the files they live in, and a test past its limit fails
once, with no teardown error."""
import ast
import pathlib
import shutil
import subprocess
import sys

from time_limits import HANGING

TESTS = pathlib.Path(__file__).resolve().parent


def _test_names(path):
    """``Class::method`` and ``function`` names of the tests in ``path``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.update(f"{node.name}::{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return names


def test_every_limited_node_id_names_a_test_that_exists():
    assert len(HANGING) == 5
    for nodeid in HANGING:
        file, name = nodeid.split("::", 1)
        path = TESTS.parent / file
        assert path.is_file(), nodeid
        assert name in _test_names(path), nodeid


SPIN_MODULE = '''
import time

import pytest

TIME_LIMIT = 0.2


def _spin(seconds):
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        pass


def test_spins():
    _spin(30.0)


def test_catches_the_limit_once_and_returns():
    try:
        _spin(30.0)
    except pytest.fail.Exception:
        pass
'''


def test_a_test_past_its_limit_fails_once_without_a_teardown_error(tmp_path):
    for name in ("conftest.py", "time_limits.py"):
        shutil.copy(TESTS / name, tmp_path / name)
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "test_spin.py").write_text(SPIN_MODULE)
    done = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    out = done.stdout
    assert done.returncode == 1, out + done.stderr
    summary = out.strip().splitlines()[-1]
    assert "2 failed" in summary and "passed" not in summary, out
    assert "error" not in summary, out
    assert "ran past its time limit of 0.2 s" in out, out
    assert "the time limit of 0.2 s fired during the test" in out, out
