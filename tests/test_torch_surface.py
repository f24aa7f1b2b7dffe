"""The port's public surface against the reference's: every name of
`spmv_tpu.__all__` is in `spmv_tpu_torch.__all__`, and where it is
callable, the reference's parameter names are among the port's (the port
may add keywords, such as `device`). Importing the port and each module
this surface reaches never imports JAX."""

import inspect
import subprocess
import sys

import pytest

import spmv_tpu
import spmv_tpu_torch

NEW_MODULES = ("spmv_tpu_torch.kernels.spgemm", "spmv_tpu_torch.kernels.trisolve",
               "spmv_tpu_torch.ops.autodiff", "spmv_tpu_torch.io.interop",
               "spmv_tpu_torch.ops.reorder", "spmv_tpu_torch.examples.pagerank",
               "spmv_tpu_torch.examples.bfs")


def _params(obj):
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):  # no signature (a builtin)
        return set()


@pytest.mark.parametrize("name", spmv_tpu.__all__)
def test_reference_name_is_in_the_port_with_its_parameters(name):
    assert name in spmv_tpu_torch.__all__
    ref, port = getattr(spmv_tpu, name), getattr(spmv_tpu_torch, name)
    if callable(ref):
        assert callable(port)
        missing = _params(ref) - _params(port)
        assert not missing, f"{name}: the port lacks parameters {sorted(missing)}"


def test_new_modules_import_no_jax():
    code = ("import sys, importlib\n"
            "import spmv_tpu_torch\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'spmv_tpu' or m.startswith('spmv_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
