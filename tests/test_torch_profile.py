"""The port's whole-run trace hook, ``PD_TPU_PROFILE=<dir>`` (the JAX
package's cli.py hook, here a torch.profiler trace): a two-step
tests/golden/parity.cfg run on the CPU writes one Chrome trace into
<dir>, holding the run's operators; without the variable, no trace."""

import json
import os

import torch

from pd_mg_pin_corrosion_tpu_torch import cli

torch.set_num_threads(2)

PARITY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "parity.cfg")
# a 100-iteration flow solve and two implicit steps of 0.6 s
TWO_STEPS = ["precision=f32", "flow_max_iters=100", "T_final=1.2"]


def test_profile_hook_writes_one_trace(tmp_path, monkeypatch):
    prof = tmp_path / "prof"
    monkeypatch.setenv("PD_TPU_PROFILE", str(prof))
    solver = cli.run([PARITY, *TWO_STEPS, f"output_dir={tmp_path / 'out'}",
                      "--device", "cpu"])
    assert solver.total_implicit_steps == 2
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".trace.json")
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)

    monkeypatch.delenv("PD_TPU_PROFILE")
    cli.run([PARITY, *TWO_STEPS, f"output_dir={tmp_path / 'again'}",
             "--device", "cpu"])
    assert os.listdir(prof) == files
