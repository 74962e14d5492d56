"""What the benchmark loads: nothing of JAX or the JAX package (by whole
top-level name) in a process that ran a cell, and nothing of the program
either where only the reference (both decodes run), the generator and the
floor are loaded."""

import json
import os
import subprocess
import sys

from conftest import ROOT

RUN_A_CELL = """
import json, sys
from fvbench import run, control
from conftest import BEAM, CELLS, tiny
for name in CELLS + (BEAM,):
    cell = run.load_cell(name, overrides=tiny(name))
    run.run_cell(cell, 5, 0.05, True, device="cpu")
    run.run_cell(cell, 5, 0.05, False, device="cpu", control=True)
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE_ONLY = """
import json, sys
import torch
import fvbench.reference, fvbench.gen, fvbench.bounds
A, B, Pi = fvbench.gen.tables(40, 5, 0.3, 1, "cpu")
ys = torch.as_tensor(fvbench.gen.observations(2, 12, 5, 1)).long()
fvbench.reference.viterbi(A, B, Pi, ys)
fvbench.reference.flash_bs(A, B, Pi, ys, 4, 2)
print(json.dumps(sorted(sys.modules)))
"""


def modules_of(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.dirname(__file__)]))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=600).stdout
    return {m.split(".", 1)[0] for m in json.loads(out.strip().splitlines()[-1])}


def test_a_run_loads_no_jax():
    tops = modules_of(RUN_A_CELL)
    assert "flash_viterbi_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "flash_viterbi_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = modules_of(REFERENCE_ONLY)
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "flash_viterbi_tpu", "flash_viterbi_tpu_torch"}
