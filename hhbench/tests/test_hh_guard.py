"""No JAX: the guard compares whole top-level names, the benchmark's
process loads none, and the reference imports nothing of the program."""

import os
import pathlib
import subprocess
import sys

from hhbench import guard

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    names = ["hedgehog_tpu_torch", "hedgehog_tpu_torch.ops.cuda_lib", "jaxtyping", "flaxen",
             "hedgehog_tpu", "hedgehog_tpu.ops", "jax", "jax.numpy", "jaxlib.xla_client", "flax"]
    assert guard.forbidden_modules(names) == sorted(names[4:])
    assert guard.forbidden_modules(["numpy", "torch"]) == []


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import hhbench.cli, hhbench.control, hhbench.requests.price_greeks_serve,"
            "hhbench.requests.solve_grad, hhbench.requests.surface_fit, hedgehog_tpu_torch;"
            "from hhbench import guard; print(guard.forbidden_modules())")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.');"
            "import hhbench.reference.heston_mixing, hhbench.reference.heston_cf,"
            "hhbench.reference.philox;"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('hedgehog')))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "hhbench/run.py", "--workload",
                          "heston_atm1y.risk_serve", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
